"""The port's dryrun entry (``brpc_tpu_torch/graft_entry.py``) against the
JAX package's ``__graft_entry__.py``: ``entry()``'s fabric step on the same
seeded frames through both (8 ranks against the 8 virtual CPU devices the
JAX tests run on), the step against its float64 formula, and the in-process
legs of ``dryrun_multichip(8, device="cpu")``.  The two-process legs (the
fabric stress, the shm ring and stripes, the N=4 pod) run in
``chip_smoke.py`` phase 23 (a); their planes have tests of their own.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from brpc_tpu_torch import graft_entry
from brpc_tpu_torch.convert import sharded_from_numpy

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 on both sides: the ring sum's order differs (psum against a fold
# in rank order), a few ulps of values near n + 1
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def jax_step():
    import jax
    import __graft_entry__ as jge
    from brpc_tpu.ici.mesh import IciMesh
    from jax.sharding import NamedSharding, PartitionSpec as P
    fn, (frames,) = jge.entry()
    mesh = IciMesh.default()
    assert mesh.size == 8
    sharding = NamedSharding(mesh.mesh, P(mesh.axis_name))
    jitted = jax.jit(fn)

    def run(np_frames):
        return np.asarray(jitted(jax.device_put(np_frames, sharding)))

    return run, np.asarray(frames)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_entry_step_matches_the_jax_package(jax_step, seed):
    run_jax, _ = jax_step
    frames = np.random.default_rng(seed).standard_normal(
        (8, graft_entry.FRAME_LEN)).astype(np.float32)
    fn, (own,) = graft_entry.entry(device="cpu")
    got = fn(sharded_from_numpy(frames, own.mesh)).stack().numpy()
    np.testing.assert_allclose(got, run_jax(frames), rtol=RTOL, atol=ATOL)


def test_entry_frames_and_step_match_the_jax_package(jax_step):
    """``entry()``'s own frames: the same (8, 4096) float32 ones, and the
    same step result."""
    run_jax, jax_frames = jax_step
    fn, (frames,) = graft_entry.entry(device="cpu")
    assert frames.shape == (8, 4096) and frames.dtype == torch.float32
    np.testing.assert_array_equal(frames.stack().numpy(), jax_frames)
    np.testing.assert_allclose(fn(frames).stack().numpy(),
                               run_jax(jax_frames), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [3, 4])
def test_entry_step_matches_its_float64_formula(seed):
    frames = np.random.default_rng(seed).standard_normal(
        (8, graft_entry.FRAME_LEN)).astype(np.float32)
    fn, (own,) = graft_entry.entry(device="cpu")
    x = sharded_from_numpy(frames, own.mesh)
    torch.testing.assert_close(
        fn(x).stack().double(),
        graft_entry.fabric_step_reference(torch.from_numpy(frames)),
        rtol=RTOL, atol=ATOL)


def test_dryrun_in_process_legs():
    """Every in-process leg of ``dryrun_multichip(8, device="cpu")`` runs
    and holds its route: the plane echo's copies equal its transfers, the
    fan-out takes the compiled route then the per-member loop, the native
    listener answers, the decode workers batch, share and migrate."""
    legs = graft_entry.dryrun_multichip(8, device="cpu",
                                        cross_process=False)
    assert list(legs) == ["step", "rpc_stack", "collective_fanout",
                          "native_door", "serving", "kv_prefix",
                          "kv_migration"]
    rs = legs["rpc_stack"]
    assert rs["plane_transfers"] == rs["plane_launches"] > 0
    assert legs["collective_fanout"]["routes"] == ["collective", "rpc"]
    assert legs["native_door"]["native_requests"] >= 1
    assert legs["serving"]["steps"] > 0
    assert legs["kv_prefix"]["shared_blocks"] == 4
    assert legs["kv_migration"]["bytes_moved"] == 64 * 4 * 256
    assert all(leg["wall_s"] < 30 for leg in legs.values())


def test_dryrun_skips_a_mesh_too_small(capsys):
    """A one-rank mesh runs the step and the echo, and prints the
    reference's SKIP line for every leg that needs more ranks."""
    legs = graft_entry.dryrun_multichip(1, device="cpu",
                                        cross_process=False)
    out = capsys.readouterr().out
    assert "collective fan-out leg SKIPPED" in out
    for phase in ("2d", "2e", "2f"):
        assert f"dryrun phase {phase} SKIP" in out
    assert legs["serving"]["skipped"] and legs["kv_migration"]["skipped"]
    assert "plane_transfers" not in legs["rpc_stack"]


def test_entry_points_ask_for_the_card():
    """Without ``device`` the dryrun builds its mesh on CUDA: here, with
    no card, it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry(device="cuda")


def test_graft_entry_loads_no_jax():
    code = ("import json, sys; import brpc_tpu_torch.graft_entry; "
            "print(json.dumps(sorted(m for m in sys.modules if m in "
            "('jax', 'brpc_tpu', 'tests', '__graft_entry__') or "
            "m.startswith(('jax.', 'jaxlib', 'brpc_tpu.', 'tests.')))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
