"""``tests/test_naming_watch.py`` on both packages
(``tests/torch_mirror.py``): the consul, nacos and discovery naming
services against golden payloads and the blocking watch against a
mocked consul.

Swaps in the port's copy: the golden-payload tests stand a fake in for
``urllib.request.urlopen``.  The port's naming services fetch through a
cancellable opener of their own (``_HttpFetcher`` in
``brpc_tpu_torch/policy/naming.py``: ``cancel`` shuts the socket of a
long poll in flight), built by ``urllib.request.build_opener`` with the
same default handlers as ``urlopen``'s (proxies from the environment,
redirects, HTTPS), so the fake stands in for ``OpenerDirector.open``,
where that opener opens a URL.

No case is left out.
"""
from __future__ import annotations

from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror("tests/test_naming_watch.py", globals(), swaps=[
    ('monkeypatch.setattr("urllib.request.urlopen", fake_urlopen)',
     'monkeypatch.setattr(\n'
     '            "urllib.request.OpenerDirector.open",\n'
     '            lambda self, url, data=None, timeout=None:\n'
     '            fake_urlopen(url, timeout=timeout))'),
])
