"""Data and tensor parallelism: the (dp, tp) layout of ranks and its
collectives (``mesh.py``), and Megatron column / row sharding of the
dense layers (``tp.py``)."""
