"""cross_card_mb_per_iter.cg: megabytes copied between two different
cards in the traced window, by the port's counter ``dist.copy_bytes``
(``DistSpDMV``'s scatter of x, its exchanges and its gather of y), per CG
iteration of the window's ``cfs.solve``s (a solve's first residual counts
with its iterations). None where the program records no
``cfs.dist.apply``: an operator on one card, or a program without the
counter."""


def read(run):
    rec = run.window_record
    if run.kind != "cg" or rec is None:
        return None
    solves = sum(s.name == "cfs.solve" for s in rec.spans)
    if not solves or not any(s.name == "cfs.dist.apply" for s in rec.spans):
        return None
    return rec.counters.get("dist.copy_bytes", 0) / 1e6 / (solves
                                                            * run.iters)
