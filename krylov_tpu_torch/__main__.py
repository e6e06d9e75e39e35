import sys

from krylov_tpu_torch.cli import main

sys.exit(main())
