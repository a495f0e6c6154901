"""Host milliseconds a sharded chunk: the mean dispatch of every card's
chunk (sharded chunks without kernel events) plus the decodes of the
chunks that reported something, shared out over all."""


def read(r):
    tr = r["trace"]
    if not tr or r["n_devices"] < 2 or not tr["dispatch_ms"] or not tr["n_dispatch"]:
        return None
    disp = sum(tr["dispatch_ms"]) / len(tr["dispatch_ms"])
    return disp + sum(tr["decode_ms"]) / tr["n_dispatch"]
