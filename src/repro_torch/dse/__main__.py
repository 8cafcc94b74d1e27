"""``python -m repro.dse`` == ``python -m repro.dse.campaign``."""
from .cli import run

raise SystemExit(run())
