"""Model components of the port: `nn.Module` parameter containers whose
parameter names are the JAX tree's flat keys, and forward functions that
mirror the JAX package's.

  layers.py                  -- linear / conv / norm primitives
  wavlm.py                   -- WavLM encoder
  llama.py                   -- LLaMA decoder + KV cache
  separator.py, ctc_head.py  -- speaker separator, serialized-CTC heads
  losses.py                  -- CE, serialized / PIT CTC, hybrid
  adapters.py                -- cross-attention adapters (decoder layers)
  bridges.py                 -- CTC frame refiner, token memory, CTC prompt
  refiners.py                -- the softmax CTC bridge's extractor
  speech_encoder_decoder.py  -- the composite model
"""
