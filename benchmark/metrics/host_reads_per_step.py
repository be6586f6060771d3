"""host_reads_per_step: host reads of tensors (item, tolist, float, int,
bool; a frozen copy of counting_reads) per converged step of the traced
episodes: a count, never a time."""


def read(run):
    steps = sum(e["steps"] for e in run["episodes"])
    return run["trace"]["reads"] / steps if steps else None
