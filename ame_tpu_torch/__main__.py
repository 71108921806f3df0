"""``python -m ame_tpu_torch``: the port's command line (``cli.py``)."""

from ame_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
