"""A decoder family's model operations in one served SOT call, one module
a family (`counts/<family>.py`, imported by the configuration's
`"family"`), for `roofline.sot_call_ops`, whose encoder and projection
terms are the family's neighbours.

Each module has one function,

    call_ops(dec, n_valid, T8, steps, int8) -> {"bf16": ops, "int8": ops}

over a batch of `len(n_valid)` rows whose speech is `T8` frames padded and
`n_valid[i]` valid: the prefill over [BOS | speech] (every linear at every
padded position, attention over the valid keys, the head at the last
frame alone), `steps` decode steps of every row with the head, and the
decode attention over the cache. With `int8` (a w8a8 decoder) the
operations that run in int8 go under "int8".

The rule a count keeps: model operations, worked out from the
configuration's shapes, the same work whatever implements it. A matrix
product counts 2 m n k once at the shapes the call runs; nothing is
counted for recomputation, padding to a kernel's tile or dequantization.
Sparse experts count the tokens times the experts each token is routed to
(top-k) plus the shared experts, never every expert a layer holds. Where
two forms of the published equations differ in work (a latent attention
with its up projections absorbed into the query and the output, or not),
count the lesser, so that no choice of form lifts `mfu` past the peak. A
module imports nothing of the program."""
