"""Data-parallel training of the port over several processes
(aanet_tpu/parallel/): ``mesh`` starts the process group and holds the
collectives that the loader, BatchNorm, the train step and validation
share."""
