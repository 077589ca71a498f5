"""dist_replay_share.cg: the share (%) of ``DistSpDMV``'s applies in the
traced window that replayed the operator's captured graph, by the port's
counter ``dist.graph_replays`` against its spans ``cfs.dist.apply``. 0
where the program has no such counter (every apply eager); None where
there is no ``cfs.dist.apply``: an operator on one card."""


def read(run):
    rec = run.window_record
    if run.kind != "cg" or rec is None:
        return None
    applies = sum(s.name == "cfs.dist.apply" for s in rec.spans)
    if not applies:
        return None
    return 100.0 * rec.counters.get("dist.graph_replays", 0) / applies
