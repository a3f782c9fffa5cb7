"""``python -m repro_torch.launch.svd_check`` — launch-side contract checker.

Thin wrapper over ``python -m repro_torch.analysis`` so the static
contract checks sit next to the other launch entry points
(``svd_dryrun``): same passes, same ``--device`` (the card unless
``cpu``), same exit semantics (nonzero on any violation that is not
allowlisted), same ``--json`` report.
"""
import sys

from repro_torch.analysis.__main__ import main

if __name__ == "__main__":
    sys.exit(main())
