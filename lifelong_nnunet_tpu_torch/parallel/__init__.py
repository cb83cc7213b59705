"""Scale-out: the data x model grid of ranks (``mesh.py``), the collectives
the train step and the sharded layers use (``collectives.py``) and the
launcher of ``-n_devices`` (``launch.py``)."""
