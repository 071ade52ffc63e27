"""Data parallelism of the port: the data axis and its collectives
(``mesh``), the process group (``multihost``) and the corpus sharded over
the data axis (``sharded_corpus``)."""
