"""Attention-mode (SOT cross-entropy) training: trainability
(`freeze.py`), the decoder LoRA (`lora.py`), AdamW with the JAX package's
semantics (`optimizer.py`), the train / eval steps (`train_step.py`) and the
`Trainer` loop (`loop.py`)."""
