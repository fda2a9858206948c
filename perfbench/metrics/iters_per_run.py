"""The mean ``RunResult.iterations`` of the window's completed runs."""


def read(rec):
    ok = [r for r in rec.runs if r.ok]
    if not ok:
        return None
    return sum(r.iterations for r in ok) / len(ok)
