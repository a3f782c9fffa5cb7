"""Runnable examples of the port, each ``python -m
repro_torch.examples.<name> [--device cpu]`` (on the card unless the CPU
is asked for; each checks its own results and exits nonzero on a miss):

* ``quickstart``     — the front door on each input type;
* ``unified_api``    — every backend with one config, the per-tier
  ``bytes_moved``, ``svd_update`` and kill-and-resume
  (``--resume-demo DIR`` across two processes);
* ``svd_service``    — the SVD service: a burst, a streamed job, an input
  error, a cancellation, the metrics;
* ``chaos_demo``     — injected faults, tier demotion and a real
  ``os._exit`` of a checkpointed child, then a bitwise resume;
* ``compress_model`` — the power method on each large 2-D weight of a
  model drawn from a seed.
"""
import argparse


def device_arg(description: str) -> argparse.ArgumentParser:
    """An argument parser with the examples' ``--device`` (default: the
    card)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="where the solves run (default: the card; "
                         "'cpu' runs the plain PyTorch versions)")
    return ap
