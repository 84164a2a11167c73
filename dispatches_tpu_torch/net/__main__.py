"""``python -m dispatches_tpu_torch.net`` — fleet worker entry point."""
import sys

from dispatches_tpu_torch.net.worker import main

sys.exit(main())
