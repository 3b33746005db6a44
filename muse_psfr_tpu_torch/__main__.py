"""``python -m muse_psfr_tpu_torch`` runs the ``muse-psfr-torch`` CLI."""

from .cli import main

if __name__ == "__main__":
    main()
