"""Training of the port: loss, metrics, optimizer and the train/eval steps
with their epoch orchestrator (aanet_tpu/train/)."""
