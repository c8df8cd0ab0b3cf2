"""GRU captioner entry point (reference main.py), on the port."""

from show_tell_tpu_torch.cli.run import run


def run_cli():
    run("gru")


if __name__ == "__main__":
    run_cli()
