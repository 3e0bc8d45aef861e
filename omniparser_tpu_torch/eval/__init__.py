"""Evaluation harnesses over the port's pipeline: the ScreenSpot-Pro adapter
(``screenspot``), the synthetic and real-pixels grounding benchmarks
(``synth_bench``, ``real_bench``) and the CLI (``python -m
omniparser_tpu_torch.eval``)."""
