"""`python -m webrtc_aecm_tpu_torch far.wav near.wav`: the demo CLI."""
from .utils.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
