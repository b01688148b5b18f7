"""Probes of the port's kernels on the card (``python -m
qoaudio_tpu_torch.experiments.<name>``); the package itself runs none."""
