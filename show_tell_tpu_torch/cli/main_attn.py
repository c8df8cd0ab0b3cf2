"""Soft-attention GRU entry point (reference Attention/main_attn.py), on the port."""

from show_tell_tpu_torch.cli.run import run


def run_cli():
    run("attn")


if __name__ == "__main__":
    run_cli()
