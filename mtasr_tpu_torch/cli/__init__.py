"""The port's command lines: `create_from_pretrained` -> `finetune_asr` ->
`inference_asr`, the JAX package's pipeline (run.sh stages 2-5), with the
same flags plus `--device` (the card unless `--device cpu`)."""
