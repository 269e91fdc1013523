import sys

from cudapathtracer_tpu_torch.cli import main

sys.exit(main())
