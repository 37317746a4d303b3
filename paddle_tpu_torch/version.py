__version__ = "0.1.0"
full_version = __version__
major, minor, patch = (int(p) for p in __version__.split("."))


def show():
    print(f"paddle_tpu {__version__}")
