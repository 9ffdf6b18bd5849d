"""`python -m mst_tpu_torch.train`: see `mst_tpu_torch.train.cli`."""

from mst_tpu_torch.train.cli import main

main()
