"""Soft-attention LSTM entry point (reference Attention/main_attn_LSTM.py), on the port."""

from show_tell_tpu_torch.cli.run import run


def run_cli():
    run("attn_lstm")


if __name__ == "__main__":
    run_cli()
