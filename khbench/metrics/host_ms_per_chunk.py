"""Host milliseconds a chunk in the search loop: the mean chunk dispatch
(chunks without kernel events) plus the summary decodes summed over the
window and shared out over its chunks."""


def read(r):
    tr = r["trace"]
    if not tr or r["n_devices"] != 1 or not tr["dispatch_ms"] or not tr["n_dispatch"]:
        return None
    disp = sum(tr["dispatch_ms"]) / len(tr["dispatch_ms"])
    return disp + sum(tr["decode_ms"]) / tr["n_dispatch"]
