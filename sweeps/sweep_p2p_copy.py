"""sweep_p2p_copy — time the p2p_copy kernel's candidate shapes against the
kernel itself and Tensor.copy_ on one NVIDIA card.

    python3 sweeps/sweep_p2p_copy.py [--kib 4 4096 32768 262144]

The candidates live in ``sweeps/p2p_copy_candidates.cu`` (the shapes that
lost to ``brpc_tpu_torch/csrc/p2p_copy.cu``); each entry of ``VARIANTS``
builds that file with some ``-D`` settings, all with the port's nvcc flags
and all in parallel, into ``brpc_tpu_torch/_build/sweep/``.  At each size
every row copies the same seeded source, is checked bit-exact against it,
and is timed against ``copy_`` in turns by ``chip_smoke.py``'s two
harnesses (``brpc_tpu_torch/tools/timing.py``): single launches with the
L2 flushed, and back-to-back launches over a rotation of buffers past the
L2.  The row ``kept`` is the package's kernel through its wrapper.  One
line per (size, variant, shape); the last line is the JSON of every row.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from brpc_tpu_torch.ici.cuda_kernel import BUILD_DIR, NVCC_FLAGS  # noqa: E402
from brpc_tpu_torch.ici.p2p_copy import p2p_copy  # noqa: E402
from brpc_tpu_torch.tools import timing  # noqa: E402

SOURCE = ROOT / "sweeps" / "p2p_copy_candidates.cu"
SHAPES = {"wave": 0, "stream": 1, "span": 2, "bulk": 3}
_NC_CS = ["-DP2P_LD=1", "-DP2P_ST_CS=1"]

# name -> (-D settings, shapes to time)
VARIANTS = {
    "plain": ([], ("wave", "stream", "span", "bulk")),
    "nc-cs": (_NC_CS, ("wave", "stream", "span")),
    "nc-cs-x8": (_NC_CS + ["-DP2P_UNROLL=8"], ("span",)),
    "x8": (["-DP2P_UNROLL=8"], ("stream",)),
    "bulk-contiguous": (["-DP2P_BULK_UNIT=0"], ("bulk",)),
    "bulk-4x16k": (["-DP2P_BULK_STAGES=4", "-DP2P_BULK_STAGE_BYTES=16384"],
                   ("bulk",)),
    "bulk-nohint": (["-DP2P_BULK_HINT=0"], ("bulk",)),
}


def build(name: str, defines: list) -> ctypes.CDLL:
    from torch.utils.cpp_extension import CUDA_HOME
    out = BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"lib{name}.so"
    proc = subprocess.run([f"{CUDA_HOME}/bin/nvcc", *NVCC_FLAGS, *defines,
                           "-o", str(lib), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed:\n{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    dll.candidate_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_ulonglong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
    dll.candidate_launch.restype = ctypes.c_int
    dll.candidate_setup.restype = ctypes.c_int
    if dll.candidate_setup() != 0:
        raise RuntimeError(f"{name}: candidate_setup failed")
    return dll


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kib", type=int, nargs="+",
                    default=[4, 4096, 32768, 262144])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_p2p_copy: needs a CUDA card", file=sys.stderr)
        return 1
    print(timing.nvidia_smi_line(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.init()
    p2p_copy.build()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda kv: build(kv[0], kv[1][0]),
                                           VARIANTS.items())))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cycles_per_us = timing.spin_cycles_per_us()
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []

    def candidate(fn, code, label):
        def call(s, d):
            rc = fn(s.data_ptr(), d.data_ptr(), s.numel(), sms, code,
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{label}: CUDA error {rc}")
        return call

    for kib in args.kib:
        n = kib << 10
        src = torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev,
                            generator=gen)
        dst = torch.empty_like(src)
        lib_dst = torch.empty_like(src)
        rot = timing.Rotation(n, 0, 0, dev, gen)
        bound_ms = 2 * n / timing.HBM_BYTES_PER_S * 1e3
        calls = [("kept", "wave", p2p_copy)]
        for name, (_, shapes) in VARIANTS.items():
            calls += [(name, shape, candidate(libs[name].candidate_launch,
                                              SHAPES[shape],
                                              f"{name} {shape}"))
                      for shape in shapes]
        for name, shape, call in calls:
            dst.zero_()
            call(src, dst)
            torch.cuda.synchronize()
            if not torch.equal(dst, src):
                raise RuntimeError(f"{name} {shape} wrong at {kib} KiB")
            single = timing.time_in_turns(
                {"ms": lambda: call(src, dst),
                 "library_ms": lambda: lib_dst.copy_(src)}, flush)
            b2b = timing.b2b_in_turns(
                {"ms": call, "library_ms": lambda s, d: d.copy_(s)},
                rot, cycles_per_us)
            for s_, d_ in rot.pairs[:4]:
                if not torch.equal(s_, d_):
                    raise RuntimeError(f"{name} {shape} wrong in the "
                                       f"rotation at {kib} KiB")
            rows.append({"kib": kib, "variant": name, "shape": shape,
                         "ms": single["ms"],
                         "library_ms": single["library_ms"],
                         "b2b_ms": b2b["ms"],
                         "b2b_library_ms": b2b["library_ms"],
                         "bound_ms": bound_ms})
            print(f"{kib:6d} KiB {name:>15} {shape:>6}: single "
                  f"{single['ms'] * 1e3:8.2f} us "
                  f"({bound_ms / single['ms']:6.1%}; copy_ "
                  f"{single['library_ms'] * 1e3:8.2f})  b2b "
                  f"{b2b['ms'] * 1e3:8.2f} us "
                  f"({bound_ms / b2b['ms']:6.1%}; copy_ "
                  f"{b2b['library_ms'] * 1e3:8.2f})", flush=True)
        del src, dst, lib_dst, rot
        torch.cuda.empty_cache()
    print(json.dumps({"rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
