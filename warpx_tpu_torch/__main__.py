"""CLI driver: ``python -m warpx_tpu_torch <inputs_deck> [key=value ...]``.

The counterpart of ``python -m warpx_tpu`` (reference: Source/main.cpp,
``warpx.3d inputs param=value``): a deck path followed by ParmParse-style
overrides.  The deck's outputs go under ``--output-dir``; ``--restart``
resumes from a checkpoint directory that a ``format = checkpoint``
diagnostic wrote.  It runs on the CUDA device unless ``--device cpu`` is
given, and raises when there is no GPU rather than run on the CPU unasked.
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
    ap.add_argument("--output-dir", default="diags",
                    help="diagnostics output directory (default: diags)")
    ap.add_argument("--f32", action="store_true",
                    help="run in single precision (default: float64)")
    ap.add_argument("--steps", type=int, default=-1,
                    help="run this many steps instead of the deck's max_step")
    ap.add_argument("--checksums", action="store_true",
                    help="print reference-format sum-abs checksums at the end")
    ap.add_argument("--restart", default=None, metavar="CHECKPOINT",
                    help="resume from a checkpoint directory written by a "
                    "format=checkpoint diagnostic")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to run (default: cuda; the CPU runs the "
                    "kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)

    import torch

    from warpx_tpu_torch.core.simulation import Simulation
    from warpx_tpu_torch.io.checkpoint import load_checkpoint
    from warpx_tpu_torch.utils.observability import WarnManager, warn

    # the CUDA default is Simulation's own, which raises without a GPU
    device = None if args.device == "cuda" else args.device
    sim = Simulation.from_deck(
        args.deck, overrides=tuple(args.overrides),
        dtype=torch.float32 if args.f32 else torch.float64, device=device,
        output_dir=args.output_dir)
    sim.init()
    if args.restart:
        sim.state, sim.is_synchronized = load_checkpoint(args.restart,
                                                         sim.state)
        print(f"restarted from {args.restart} at step {sim.state.step}")
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
        warn("Inputs", "unused deck keys: " + ", ".join(unused), "low")
    # the end-of-run warning summary (WarnManager.H:227)
    mgr = WarnManager.instance()
    if not mgr.empty:
        mgr.print_summary(sys.stderr)
        mgr.reset()
    return 0


if __name__ == "__main__":
    sys.exit(main())
