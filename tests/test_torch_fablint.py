"""fablint on both packages: every test of ``tests/test_fablint.py`` over
``brpc_tpu`` and over ``brpc_tpu_torch`` (``tests/torch_mirror.py``).

The port's copy runs ``brpc_tpu_torch.tools.fablint``: the seeded
fixtures under ``tests/fixtures/fablint/`` (read as they are) at the same
file:line, and the zero-findings gate over ``brpc_tpu_torch/`` (its
``PKG`` is the port's package directory): the concurrency, dead-code and
custody passes and the four CLI commands exit 0,
``test_custody_maps_on_all_six_modules`` and
``test_hot_modules_declare_guard_maps`` read the port's modules of the
same names.  No case is left out and nothing is swapped.

Beyond the mirror: the port's analyzer knows ``synchronize`` (the host's
wait on the card, through ``torch.cuda``, a ``Stream`` or an ``Event``)
as a blocking call, the counterpart of the reference's ``device_put`` and
``jit``.
"""
from __future__ import annotations

from tests import torch_mirror

torch_mirror.mirror("tests/test_fablint.py", globals())


def test_port_analyzer_flags_a_card_wait_under_a_lock(tmp_path):
    from brpc_tpu_torch.tools import fablint
    mod = tmp_path / "m.py"
    mod.write_text(
        "import threading\nimport torch\n"
        "_lock = threading.Lock()\n"
        "def f(stream, ev):\n"
        "    with _lock:\n"
        "        torch.cuda.synchronize()\n"
        "        stream.synchronize()\n"
        "        ev.synchronize()\n"
        "    torch.cuda.synchronize()\n")
    out = fablint.run([str(mod)], fablint.CONCURRENCY_RULES)
    assert [(f.rule, f.line) for f in out] == [
        ("blocking-under-lock", 6), ("blocking-under-lock", 7),
        ("blocking-under-lock", 8)]
    assert all("synchronize" in f.message for f in out)
