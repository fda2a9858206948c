"""The mean, over the window's completed runs, of a run's wall time less
the program's own ``RunResult.seconds`` (the fused engine's launches
and polls): ``run``'s host work before and after its loop, in ms."""


def read(rec):
    ok = [r for r in rec.runs if r.ok]
    if not ok:
        return None
    return sum(r.wall_s - r.seconds for r in ok) / len(ok) * 1e3
