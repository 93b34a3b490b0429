import sys

from tendermint_tpu_torch.cli import main

sys.exit(main())
