"""paddle_tpu_torch.hapi: the model zoo's weight loading
(``weights.load_weights``, port of paddle_tpu/hapi/weights.py). The rest
of the reference's ``hapi/`` (``Model``, ``summary``, ``flops``) is
ROADMAP Queue 1 item 7."""
