"""`python -m nomad_tpu_torch`: the command line (cli/main.py)."""

from .cli.main import main

if __name__ == "__main__":
    raise SystemExit(main())
