"""A mongo-wire key-value service: the server answers OP_MSG commands
(insert, find, ping) with BSON documents, the mongo_protocol adaptor's
pattern, and needs no client library of mongo's.

    python -m brpc_tpu_torch.examples.mongo_service            # card
    python -m brpc_tpu_torch.examples.mongo_service --device cpu
"""
from __future__ import annotations

import sys

from brpc_tpu_torch import rpc
from brpc_tpu_torch.examples.common import parse_device, setup_mesh
from brpc_tpu_torch.policy.mongo import (MongoRequest, MongoResponse,
                                         MongoService)


class KvMongo(MongoService):
    def __init__(self):
        self.store = {}

    def process(self, cntl, doc):
        if "ping" in doc:
            return {"ok": 1}
        if "insert" in doc:
            for d in doc.get("documents", []):
                self.store[d["_id"]] = d
            return {"ok": 1, "n": len(doc.get("documents", []))}
        if "find" in doc:
            hit = self.store.get(doc.get("filter", {}).get("_id"))
            return {"ok": 1, "cursor": {"firstBatch": [hit] if hit else [],
                                        "id": 0}}
        return {"ok": 0, "errmsg": f"unknown command {list(doc)[:1]}"}


def main(argv=None) -> int:
    setup_mesh(parse_device(argv, __doc__))
    server = rpc.Server()
    server.add_service(KvMongo())
    ch = rpc.Channel()
    try:
        if server.start("mem://example-mongo") != 0:
            return 1
        ch.init("mem://example-mongo",
                options=rpc.ChannelOptions(timeout_ms=2000,
                                           protocol="mongo"))
        cntl = rpc.Controller()
        r = ch.call_method("mongo", cntl, MongoRequest(
            {"insert": "kv", "documents": [{"_id": "a", "v": 1},
                                           {"_id": "b", "v": 2}]}),
            MongoResponse)
        if cntl.failed() or r.doc["n"] != 2:
            return 1
        cntl = rpc.Controller()
        r = ch.call_method("mongo", cntl, MongoRequest(
            {"find": "kv", "filter": {"_id": "b"}}), MongoResponse)
        if cntl.failed():
            print(f"call failed: {cntl.error_text}")
            return 1
        batch = r.doc["cursor"]["firstBatch"]
        print(f"mongo find -> {batch}")
        return 0 if batch[0]["v"] == 2 else 1
    finally:
        ch.close()
        server.stop()


if __name__ == "__main__":
    sys.exit(main())
