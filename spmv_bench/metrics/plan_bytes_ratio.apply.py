"""plan_bytes_ratio.apply: the bytes of the tensors that the program's
appliers pass to their launches (``harness.operand_bytes`` of the tuned
matrix's operands, as uploaded: values, indices, tables) over the bytes of
the stored values in the configuration's precision: a count."""


def read(run):
    if run.kind != "apply":
        return None
    return run.plan_bytes / run.value_bytes
