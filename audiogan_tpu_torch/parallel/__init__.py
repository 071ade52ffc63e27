"""Parallelism of the port: the mesh's axes and their collectives
(``mesh``), the process group (``multihost``), the corpus sharded over
the data axis (``sharded_corpus``), context parallelism (``halo``,
``cp_models``) and tensor parallelism (``tp``, ``tp_models``)."""
