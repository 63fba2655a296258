"""``python -m repro_torch.obs``: see ``obs.run.main``. Importing this
module runs nothing."""
import sys

from repro_torch.obs.run import main

if __name__ == "__main__":
    sys.exit(main())
