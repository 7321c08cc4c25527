"""The plain reference that decides `correct`: the served model's function
written again in plain PyTorch, float32 with TF32 off, one file per
component. It reads the weights the harness made (the same tensors it
handed the program, int8 ones dequantized here) by their flat names, and
works out for itself everything the program derives from the inputs
(normalisation, padding, masks, positions, the relative-position buckets,
the rotary tables). It imports nothing of the program.

`quant` (None, 8 or 4) computes the same function with every linear's
weight and input, and every cached key and value, rounded to that many
bits (symmetric, one scale a row): the lower-precision control."""
