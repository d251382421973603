"""The port copy's swaps for ``tests/test_serving.py``, shared by its two
twins (``tests/test_torch_twin_serving_pool.py`` and
``tests/test_torch_twin_serving_step.py``):

- import paths: the toy model and the workers from
  ``brpc_tpu_torch/examples/disagg_serving/``, the echo messages from
  ``brpc_tpu_torch/proto/echo_pb2.py``;
- an explicit ``device="cpu"`` where the JAX test relies on JAX's CPU
  default: the pool (``PagedKvPool(opts, device="cpu")``) and the toy
  model's ``toy_kv_blocks``/``reference_generate`` (``_model()`` returns
  the port's model with ``device="cpu"`` bound);
- the CPU default mesh: the port's copy runs on an 8-rank CPU mesh
  (``cpu_mesh=True``), and a worker the JAX test starts on
  ``jax.devices()[k]`` starts on rank k of it (``rank=k``);
- ``jax.numpy`` -> ``torch``: ``import torch as jnp``, with the dtype of
  ``jnp.zeros(n, jnp.uint8)`` passed as ``dtype=`` (torch takes no
  positional dtype);
- a private name the port spells differently: the scheduler's eager
  step is ``_step_eager`` (the JAX ``_step_numpy`` runs numpy, the
  port's runs torch on the pool's device).
"""
from __future__ import annotations

_PORT_MODEL = '''def _model():
    import functools
    import types
    from examples.disagg_serving import model
    return types.SimpleNamespace(**{
        **vars(model),
        "toy_kv_blocks": functools.partial(model.toy_kv_blocks,
                                           device="cpu"),
        "reference_generate": functools.partial(model.reference_generate,
                                                device="cpu")})'''

SWAPS = [
    ("def _model():\n    from examples.disagg_serving import model\n"
     "    return model", _PORT_MODEL),
    ("from examples.example_echo_pb2", "from brpc_tpu.proto.echo_pb2"),
    ("from examples.disagg_serving", "from brpc_tpu.examples.disagg_serving"),
    ("PagedKvPool(opts, now=now)", 'PagedKvPool(opts, device="cpu", now=now)'),
    ("PagedKvPool(opts)", 'PagedKvPool(opts, device="cpu")'),
    ("import jax.numpy as jnp", "import torch as jnp"),
    ("jnp.zeros(7, jnp.uint8)", "jnp.zeros(7, dtype=jnp.uint8)"),
    ("jnp.zeros(len(big), jnp.uint8)",
     "jnp.zeros(len(big), dtype=jnp.uint8)"),
    ("device=devs[7]", "rank=7"),
    ("device=devs[6]", "rank=6"),
    ("sched._step_numpy", "sched._step_eager"),
]
