"""Training: AdamW (optimizer), the train step with microbatches
(train_step), int8 gradient compression with error feedback
(grad_compress) and checkpoints in the reference's on-disk format
(checkpoint)."""
