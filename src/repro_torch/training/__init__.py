"""Training on the port: data streams, AdamW, the train step and its
fault-tolerant driver (port of ``repro.training``)."""
