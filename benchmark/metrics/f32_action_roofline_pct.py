"""f32_action_roofline_pct: the f32 stiffness action y = A(CT) u (the
Krylov operator) against the least time the chip could take for it.

Work per call, from the mesh's shapes (E elements, N nodes), as a map:
- bytes: each element's tangent (36 values, the volume folded in), its
  shape-function gradients (12) and its connectivity (4 indices) read once,
  u read once and y written once, all 4-byte: 4 (52 E + 6 N).  This is
  what y = sum_e B_e^T (V_e CT_e) B_e u needs; what a kernel stores or
  reads again (padding, halos, the other gradient layout) is not counted.
- operations: per element the strain (4 nodes x 9 gradient terms, a
  multiply and an add each: 72), the stress CT:eps (36 multiply-adds: 72),
  the 12 nodal forces (12 x 3 multiply-adds: 72) and their scatter (12
  adds): 228 E.
The least time is the larger of the bytes over the HBM rate and the
operations over the float32 rate of ``peaks.json`` (the card the run
names); the share is the least time times the calls, over the device time
the profiler gives the kernels that the ``kernels/*.json`` files name, in
the profiled episode.  Nothing when those kernels did not run, or the card
is not in the table.
"""
from devtrace import kernel_base as base

BYTES_PER_ELEM, BYTES_PER_NODE = 4 * 52, 4 * 6
FLOPS_PER_ELEM = 228


def least_seconds(n_elems, n_nodes, peak):
    nbytes = BYTES_PER_ELEM * n_elems + BYTES_PER_NODE * n_nodes
    return max(nbytes / peak["hbm_byte_per_s"],
               FLOPS_PER_ELEM * n_elems / peak["f32_flop_per_s"])


def read(run):
    prof = run["trace"].get("profile")
    peak = run["peak"]
    if not prof or peak is None:
        return None
    calls = seconds = 0
    for impl in run["kernels"]:
        names = impl["kernels"]
        hits = {k: v for k, v in prof["kernels"].items()
                if base(k) in names}
        calls += sum(v[0] for k, v in hits.items()
                     if base(k) == impl["per_call"])
        seconds += sum(v[1] for v in hits.values())
    if not calls or not seconds:
        return None
    shape = run["shapes"]
    return 100.0 * calls * least_seconds(shape["n_elems"], shape["n_nodes"],
                                         peak) / seconds
