"""Whether an episode of the program is correct: its saved fields, read
back from the files it wrote, and its state at the episode's end, against
the plain reference's run of the same episode.

The numbers compared, each against the cell's limit in
``limits/<cell>.json``:

- ``saves_missing``: kept saves the traffic asks for and the files lack,
  over every field (limit 0);
- ``fields_gap``: over every kept save of every field, the largest
  max|program - reference| / max|reference|, a stress field (``p_elems``,
  ``q_elems``) measured against the larger of its own max|reference| and
  the stress's at the episode's end (a von Mises stress near zero in a
  nearly hydrostatic region is round-off);
- ``state_gap``: the same over the state a checkpoint holds (u, stress,
  strain, and each mechanism's inelastic strain and internal variables),
  the worst leaf.  A strain-like leaf (a mechanism's inelastic strain or
  accumulated strain) is measured against the larger of its own max|ref|
  and the total strain's: a mechanism whose strain is all but zero next to
  the total moves by round-off alone.

The program numbers its nodes and elements its own way; both are matched
to the mesh file's by their coordinates and node sets.
"""
from __future__ import annotations

import os

import numpy as np

from h5read import H5Reader


def _order(rows):
    """Row indices of ``rows`` (n, k) in lexicographic order."""
    return np.lexsort(rows.T[::-1])


def match(prog_points, prog_tets, ref_points, ref_tets):
    """(node, elem): the reference index of each program node and element;
    raises when the meshes differ."""
    pi, ri = _order(prog_points), _order(ref_points)
    if not np.array_equal(prog_points[pi], ref_points[ri]):
        raise ValueError("the program's mesh is not the reference's")
    node = np.empty(len(pi), np.int64)
    node[pi] = ri
    pt = np.sort(node[prog_tets], axis=1)
    rt = np.sort(ref_tets, axis=1)
    pe, re = _order(pt), _order(rt)
    if not np.array_equal(pt[pe], rt[re]):
        raise ValueError("the program's elements are not the reference's")
    elem = np.empty(len(pe), np.int64)
    elem[pe] = re
    return node, elem


STRAIN_LIKE = ("eps_old", "qsi_old")
STRESS_FIELDS = ("p_elems", "q_elems")


def gap(prog, ref, floor=0.0):
    """max|prog - ref| / max(max|ref|, floor) (inf for a non-finite or
    misshapen program array)."""
    prog = np.asarray(prog, np.float64)
    if prog.shape != ref.shape or not np.isfinite(prog).all():
        return float("inf")
    scale = max(np.abs(ref).max(), floor)
    return float(np.abs(prog - ref).max() / (scale if scale > 0 else 1.0))


def to_ref(arr, perm, n_ref):
    """A program array indexed by its own numbering, in the reference's."""
    out = np.full((n_ref,) + arr.shape[1:], np.nan)
    out[perm] = arr
    return out


def judge(out_dir, checkpoint, ref, fields):
    """{name: value} of the numbers compared for the episode whose outputs
    are under ``out_dir`` and whose end state is the checkpoint file.  A
    file that is missing or unreadable counts its saves as missing and its
    gap as infinite."""
    bad = {"saves_missing": float(sum(len(v) for v in ref["saves"].values())),
           "fields_gap": float("inf"), "state_gap": float("inf")}
    try:
        with H5Reader(os.path.join(out_dir, fields[0],
                                   f"{fields[0]}.h5")) as h5:
            pts = h5.read("Mesh/geometry")
            tets = h5.read("Mesh/topology")
        node, elem = match(pts, tets, ref["points"], ref["tets"])
    except (OSError, KeyError, ValueError):
        return bad
    n_nodes = len(ref["points"])
    perm_of = lambda a: node if a.shape[0] == n_nodes else elem  # noqa
    missing, fgap = 0, 0.0
    stress = np.abs(ref["state"]["sig_v"]).max()
    for name in fields:
        floor = stress if name in STRESS_FIELDS else 0.0
        want = ref["saves"][name]
        try:
            with H5Reader(os.path.join(out_dir, name, f"{name}.h5")) as h5:
                have = sorted(h5.keys(f"Function/{name}"), key=int)
                missing += max(len(want) - len(have), 0)
                for k, r in zip(have, want):
                    a = h5.read(f"Function/{name}/{k}").reshape(r.shape)
                    fgap = max(fgap, gap(to_ref(a, perm_of(a), r.shape[0]),
                                         r, floor))
        except (OSError, KeyError, ValueError):
            missing, fgap = missing + len(want), float("inf")
    sgap = 0.0
    strain = np.abs(ref["state"]["eps_tot_v"]).max()
    with np.load(checkpoint) as z:
        for key, r in ref["state"].items():
            a = z[key] if key in z.files else np.full(r.shape, np.nan)
            floor = strain if key.endswith(STRAIN_LIKE) else 0.0
            sgap = max(sgap, gap(to_ref(a, perm_of(a), r.shape[0]), r,
                                 floor))
    return {"saves_missing": float(missing), "fields_gap": fgap,
            "state_gap": sgap}
