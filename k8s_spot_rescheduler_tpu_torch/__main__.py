import sys

from k8s_spot_rescheduler_tpu_torch.cli.main import main

sys.exit(main())
