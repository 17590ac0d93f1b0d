"""``python3 -m aligntools_tpu_torch batch ...``: the port's CLI, for hosts
where the console script is not installed."""

import sys

from aligntools_tpu_torch.cli import main

sys.exit(main())
