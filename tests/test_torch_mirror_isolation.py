"""A mirrored JAX test file and its twin pass whole in one worker, in
either order: ``tests/torch_mirror.py`` runs each copied test on the flag
registry as it stood before it, without the flags the file defines by
name, and puts the registry back after it.  Before that, ``tests/
test_butil.py``'s ``TestFlags.test_define_get_set`` and its JAX copy in
``tests/test_torch_butil.py`` failed whichever ran second (``assert 16 ==
4``: the first run left ``test_flag_x`` at 16, and ``define_flag`` returns
a flag that already exists).  Each order runs in a pytest of its own
with xdist off, as ``--dist loadfile`` can put the two files on one
worker."""
from __future__ import annotations

import os
import re
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PAIR = ("tests/test_butil.py", "tests/test_torch_butil.py")


def test_butil_and_its_twin_pass_in_either_order():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    for order in (_PAIR, _PAIR[::-1]):
        p = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-p", "no:xdist",
             "-p", "no:cacheprovider", "-p", "no:randomly", *order],
            cwd=_REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, timeout=40)
        out = p.stdout
        tail = out[-4000:]
        assert p.returncode == 0, tail
        summary = out.strip().splitlines()[-1]
        assert re.fullmatch(r"\d+ passed in [\d.]+s", summary.strip("= ")), \
            tail
        # each file's flags test ran, and on both packages in the twin
        assert "failed" not in summary and "error" not in summary, tail
