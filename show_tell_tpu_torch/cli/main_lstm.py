"""LSTM captioner entry point (reference LSTM/main_lstm.py), on the port."""

from show_tell_tpu_torch.cli.run import run


def run_cli():
    run("lstm")


if __name__ == "__main__":
    run_cli()
