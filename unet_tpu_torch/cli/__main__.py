import sys

from unet_tpu_torch.cli.main import main

sys.exit(main())
