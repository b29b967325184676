import sys

from sofa_tpu_torch.cli import main

sys.exit(main())
