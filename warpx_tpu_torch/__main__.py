"""CLI driver: ``python -m warpx_tpu_torch <inputs_deck> [key=value ...]``.

The counterpart of ``python -m warpx_tpu`` (reference: Source/main.cpp,
``warpx.3d inputs param=value``): a deck path followed by ParmParse-style
overrides.  It runs on the CUDA device unless ``--device cpu`` is given,
and raises when there is no GPU rather than run on the CPU unasked.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m warpx_tpu_torch",
        description="PIC simulation driver of the PyTorch + CUDA port",
    )
    ap.add_argument("deck", help="path to a ParmParse inputs deck")
    ap.add_argument(
        "overrides", nargs="*",
        help='deck overrides, ParmParse style: key=value; quote lists, '
        'e.g. "amr.n_cell=32 32 32"',
    )
    ap.add_argument("--output-dir", default=None,
                    help="diagnostics output directory (not ported)")
    ap.add_argument("--f32", action="store_true",
                    help="run in single precision (default: float64)")
    ap.add_argument("--steps", type=int, default=-1,
                    help="run this many steps instead of the deck's max_step")
    ap.add_argument("--checksums", action="store_true",
                    help="print reference-format sum-abs checksums at the end")
    ap.add_argument("--restart", default=None, metavar="CHECKPOINT",
                    help="resume from a checkpoint directory (not ported)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to run (default: cuda; the CPU runs the "
                    "kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)
    for flag, given in (("--output-dir", args.output_dir),
                        ("--restart", args.restart)):
        if given is not None:
            raise NotImplementedError(
                f"{flag}: diagnostics and checkpoints (ROADMAP.md Queue A 13)")

    import torch

    from warpx_tpu_torch.core.simulation import Simulation

    # the CUDA default is Simulation's own, which raises without a GPU
    device = None if args.device == "cuda" else args.device
    sim = Simulation.from_deck(
        args.deck, overrides=tuple(args.overrides),
        dtype=torch.float32 if args.f32 else torch.float64, device=device)
    sim.init()
    t0 = time.perf_counter()
    sim.evolve(args.steps)
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)
    elapsed = time.perf_counter() - t0
    print(f"completed {int(sim.state.step)} steps in {elapsed:.3f} s "
          f"(t = {float(sim.state.time):.6e} s)")
    if args.checksums:
        print(json.dumps(sim.checksums(), indent=2, sort_keys=True))
    unused = sim.deck.unused_keys()
    if unused:
        print("unused deck keys: " + ", ".join(unused), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
