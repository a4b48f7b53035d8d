"""The port's counterparts of the JAX package's model plugins under
``recipes/`` (``models/plugin.py::PORTED``)."""
