"""Training of the port (port of ``repro/training``): the data pipelines
(``data.py``), AdamW (``optimizer.py``), the train step
(``train_step.py``), the gradient and KV wire codecs (``compression.py``),
checkpoints (``checkpoint.py``) and the fault-tolerant supervisor
(``fault_tolerance.py``)."""
