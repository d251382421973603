"""The toy prefill's bytes do not depend on how torch splits its work.

``toy_kv_blocks`` quantizes ``sin`` plus a running sum to uint8, where a
float that moves by a few ulps can move a byte.  ``torch.sin`` on the CPU
runs MKL's vector sin chunk by chunk on the OpenMP pool; under load some
pool threads' chunks came back up to ~1e-4 off (the serving demo then
answered its first prompt with other tokens).  The port computes ``sin``
from elementwise float64 adds and multiplies instead (``sin_f32``).  These
tests hold the port's bytes against the JAX package's ``toy_kv_blocks``,
exactly, at every intra-op thread count, from concurrent threads, and
the JAX package's own bytes against a single-threaded run of it.
"""
import hashlib
import json
import math
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from brpc_tpu_torch.examples.disagg_serving import model as tmodel
from examples.disagg_serving import model as jmodel

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the demo's four prompts, then longer ones over the whole vocabulary
PROMPTS = ([[(7 * i + j) % 997 for j in range(96 + 16 * i)]
            for i in range(4)]
           + [[(31 * j + 7) % tmodel.VOCAB for j in range(n)]
              for n in (512, 2048)])

THREADS = sorted({1, 2, 3, 4, os.cpu_count() or 1})


@pytest.fixture(scope="module")
def jax_bytes():
    return [np.asarray(jmodel.toy_kv_blocks(p)) for p in PROMPTS]


@pytest.fixture
def restore_threads():
    n = torch.get_num_threads()
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("k", THREADS)
def test_prefill_bytes_equal_jax_at_every_thread_count(k, jax_bytes,
                                                       restore_threads):
    torch.set_num_threads(k)
    assert torch.get_num_threads() == k
    for p, want in zip(PROMPTS, jax_bytes):
        got = tmodel.toy_kv_blocks(p, device="cpu").numpy()
        assert got.shape == want.shape
        assert np.array_equal(got, want), (
            f"{len(p)} tokens at {k} threads: "
            f"{int((got != want).sum())} bytes differ")


def test_prefill_bytes_equal_jax_from_concurrent_threads(jax_bytes):
    """Four Python threads prefill at once, each on the shared OpenMP
    pool: the demo's handlers and its reference run this way."""
    bad = []

    def work():
        for _ in range(3):
            for p, want in zip(PROMPTS[:4], jax_bytes[:4]):
                got = tmodel.toy_kv_blocks(p, device="cpu").numpy()
                if not np.array_equal(got, want):
                    bad.append(len(p))

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad, bad


def test_sin_f32_is_correctly_rounded_sin():
    """The float64 evaluation rounds to the float32 nearest the true sin,
    over the prefill's range of arguments and their negatives."""
    g = torch.Generator().manual_seed(7)
    x = torch.rand(20000, generator=g, dtype=torch.float32) * 2.1e5
    x = torch.cat([x, x / 4096, -x])
    want = torch.tensor([math.sin(v) for v in x.double().tolist()],
                        dtype=torch.float64).float()
    got = tmodel.sin_f32(x)
    assert torch.equal(got, want), int((got != want).sum())


_JAX_ONE_THREAD = r"""
import hashlib, json, sys
sys.path.insert(0, %(repo)r)
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from examples.disagg_serving import model
prompts = json.loads(sys.argv[1])
print(json.dumps([hashlib.sha1(np.asarray(model.toy_kv_blocks(p)).tobytes())
                  .hexdigest() for p in prompts]))
"""


def test_jax_prefill_does_not_depend_on_its_thread_count(jax_bytes):
    """The reference itself: XLA's CPU backend with one intra-op thread
    and no Eigen pool gives the bytes the default run gives."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = ("--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1")
    out = subprocess.run(
        [sys.executable, "-c", _JAX_ONE_THREAD % {"repo": _REPO},
         json.dumps(PROMPTS)],
        capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    single = json.loads(out.stdout.strip().splitlines()[-1])
    assert single == [hashlib.sha1(b.tobytes()).hexdigest()
                      for b in jax_bytes]
