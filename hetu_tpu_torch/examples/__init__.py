"""Entry scripts of the port, run as modules
(``python -m hetu_tpu_torch.examples.cnn_main``)."""
