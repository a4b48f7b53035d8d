"""Host-side tools of the port: n-gram LM training and binary conversion
(``ngram_lm``), beam dumps (``rescore``), the synthetic corpus
(``synth_corpus``), the convergence soak (``soak``), the import of torch
ConvLM checkpoints (``convlm_import``) and the pseudo-label filters of
self-training (``pseudo_label``)."""
