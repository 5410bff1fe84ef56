"""Data parallelism and serving: the process group and data mesh
(:mod:`.mesh`) and the continuous-batching engine (:mod:`.serving`)."""
