"""Entry point: ``python -m repro_torch.tune`` (see
:mod:`repro_torch.tune.cli`)."""

from .cli import main

if __name__ == "__main__":
    main()
