"""dist_host_us_per_iter.cg: host microseconds of ``DistSpDMV``'s applies
in the traced window, by the port's spans ``cfs.dist.apply`` (the scatter,
each shard's launches and exchange, the gather), per CG iteration of the
window's ``cfs.solve``s. With the solver's loop eager across cards, this
is the host's dispatch of the shards. None where there is no such
span."""


def read(run):
    rec = run.window_record
    if run.kind != "cg" or rec is None:
        return None
    solves = sum(s.name == "cfs.solve" for s in rec.spans)
    applies = [s for s in rec.spans if s.name == "cfs.dist.apply"]
    if not solves or not applies:
        return None
    return sum(s.t1 - s.t0 for s in applies) / 1e3 / (solves * run.iters)
