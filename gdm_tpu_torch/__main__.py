"""``python -m gdm_tpu_torch ...`` runs the command line of
gdm_tpu_torch/cli.py."""

from gdm_tpu_torch.cli import main

if __name__ == "__main__":
    main()
