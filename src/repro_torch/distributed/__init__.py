"""Fault tolerance (``StragglerPolicy``, ``TrainSupervisor``) and gradient
compression of the port."""
