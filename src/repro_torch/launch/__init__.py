"""Launchers of the port (the JAX package's ``launch/``): ``train``, the
training launcher (``python -m repro_torch.launch.train``), and ``mesh``,
the process meshes it trains over."""
