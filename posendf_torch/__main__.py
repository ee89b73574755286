"""``python -m posendf_torch``: the command line (see cli.py)."""

from posendf_torch.cli import main

if __name__ == "__main__":
    main()
