"""`python -m barcode_tpu_torch input.par ...`: see barcode_tpu_torch.cli."""
import sys

from barcode_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
