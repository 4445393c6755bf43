"""Kernel K1 (``warpx_tpu_torch/csrc/fused_pic.cu``) against a parent
source, the parent's ablations and its own lever ablations, on the 3D main
path's inputs, on one card.

    python3 k1_ab.py

Run from the repository's root, beside ``chip_smoke.py`` and ``k2_ab.py``,
whose helpers it runs.  ``_ab/parent/`` (git-ignored) holds the parent
commit's ``fused_pic.cu`` and ``fused_pic_common.cuh``:

    mkdir -p _ab/parent && for f in fused_pic.cu fused_pic_common.cuh; do
      git show <rev>:warpx_tpu_torch/csrc/$f > _ab/parent/$f; done

Each variant is a copy of a source with the named edits (PARENTS of the
parent's, VARIANTS of this kernel's), built by ``nvcc`` for float32 at
order 1 into ``warpx_tpu_torch/_build/k1_ab/`` (git-ignored); the
ablations give wrong current windows where they say so and exist for timing
only.  The inputs are uniform-128 (``chip_smoke.main_cfg``) after 4 steps
and at the end of ``chip_smoke.py``'s main run (25 steps, the closing
half-push included); in each state and precision mode every variant runs on
the same inputs against the first (the parent): particles and violation
counts bitwise, J relative; then ten launches timed with CUDA events, three
rounds in the order first..last, last..first.  Prints one JSON line per
result, as ``k2_ab.py`` does.
"""

from __future__ import annotations

import torch

import chip_smoke as cs
import k2_ab

from warpx_tpu_torch.ops import fused_pic as fp

# (old, new) edits of the parent's csrc/fused_pic.cu, each found exactly once
PARENTS = {
    "parent": [],
    # no deposit: each slot ends after its violation count (J stays zero)
    "parent_nodep": [("if (bad && w > T(0)) atomicAdd(&s_viol, 1);",
                      "if (bad && w > T(0)) atomicAdd(&s_viol, 1);\n"
                      "        continue;")],
    # the deposit's shared atomics replaced by plain stores (wrong J)
    "parent_store": [("\n                if (v != T(0)) atomicAdd(Jd + "
                      "(row_ * W + ra) * W + rb, v);",
                      "\n                if (v != T(0)) Jd[(row_ * W + ra) * W"
                      " + rb] = v;")],
}

_THREADS = ("return sizeof(T) == 8 || ORDER > 1 ? 192 : MXU == kMxuF32 ? 256 : "
            "160;")
_BLOCKS = "return sizeof(T) == 8 ? 1 : ORDER > 1 || MXU == kMxuF32 ? 2 : 3;"
_FAST_ADD = "if (v != T(0)) global_add(Jd + (r * W + ja) * W + jb, v);"

# (old, new) edits of csrc/fused_pic.cu, each found exactly once
VARIANTS = {
    "new": [],
    # lever 3 off: the box is the window at uniform-128's W = 16
    "noL3": [("return 12 + ORDER;", "return 16;")],
    # lever 4 off: the first design's 256 threads, no resident-block bound
    "noL4": [(_THREADS, "return 256;"), (_BLOCKS, "return 1;")],
    # one block shape in every mode: threads x resident blocks asked of
    # ptxas (192 x 4 is 80 registers, with which float32 spills)
    "b192x4": [(_THREADS, "return 192;"), (_BLOCKS, "return 4;")],
    "b160x3": [(_THREADS, "return 160;"), (_BLOCKS, "return 3;")],
    "b256x2": [(_THREADS, "return 256;"), (_BLOCKS, "return 2;")],
    # the deposit keeps the running sum's residue rows on the deposit axis
    # (order + 2 rows: only the row neither stencil touches is dropped)
    "resid": [("    for (int r = 0; r <= ORDER; ++r) {\n"
               "      if (r >= last) continue;\n",
               "    for (int r = 0; r < NU; ++r) {\n")],
    # the deposit by atomicAdd, which one build compiled to the
    # value-returning ATOMG
    "atomg": [(_FAST_ADD, "if (v != T(0)) atomicAdd(Jd + (r * W + ja) * W"
               " + jb, v);")],
    # the deposit's atomics replaced by plain stores (wrong J)
    "store": [(_FAST_ADD, "if (v != T(0)) Jd[(r * W + ja) * W + jb] = v;")],
    # no deposit at all (J stays zero)
    "nodep": [("  if (bad && w > T(0)) atomicAdd(s_viol, 1);\n"
               "  if (wq == T(0)) return true;\n",
               "  if (bad && w > T(0)) atomicAdd(s_viol, 1);\n"
               "  return true;\n")],
}


def states(dev, smi):
    """uniform-128 after 4 steps, then at the end of chip_smoke.py's main
    run (init, 24 steps, the closing step)."""
    import warpx_tpu_torch
    from warpx_tpu_torch.core.binned_step import pusher_groups

    cfg = cs.main_cfg(128)
    sim = warpx_tpu_torch.Simulation(cfg, dtype=torch.float32, device=dev)
    sim.init()

    def inputs():
        f = sim.state.fields
        fields6 = fp.pad_fields((f.Ex, f.Ey, f.Ez, f.Bx, f.By, f.Bz),
                                sim.tile_spec)
        ((pname, _, params, parts, counts),) = list(
            pusher_groups(sim.state, sim.tile_spec, sim.params))
        return (params, fields6, parts, counts), pname

    sim.evolve(4)
    yield ("uniform128_step4", sim, *inputs(), {})
    sim.evolve(20)
    sim.evolve()
    yield ("uniform128_end", sim, *inputs(), {})


def main() -> int:
    return k2_ab.run_ab("k1_ab", "fused_pic", 1, PARENTS, VARIANTS, states)


if __name__ == "__main__":
    raise SystemExit(main())
