"""Host milliseconds of one summary's decode and check (the engine's
_consume_summary or _decode_fast with its verification), a mean over the
window's decodes."""


def read(r):
    tr = r["trace"]
    if not tr or r["n_devices"] != 1 or not tr["decode_ms"]:
        return None
    return sum(tr["decode_ms"]) / len(tr["decode_ms"])
