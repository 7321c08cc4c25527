from mtasr_tpu_torch.generate.beam import BeamOutput, beam_generate
from mtasr_tpu_torch.generate.engine import GenerateOutput, generate
from mtasr_tpu_torch.generate.speculative import (
    SpecStats, generate_speculative,
)

__all__ = ["BeamOutput", "GenerateOutput", "SpecStats", "beam_generate",
           "generate", "generate_speculative"]
