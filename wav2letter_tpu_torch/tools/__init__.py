"""Host-side tools of the port, copies of the JAX package's: n-gram LM
training and binary conversion (``ngram_lm``), the production-scale
lexicon and 4-gram (``prod_scale``), corpus trees to lists (``data_prep``),
word pieces (``wordpiece``), the LM corpus chain (``corpus``), char-LM
perplexities (``char_lm_eval``), the LM-bias analysis (``lm_analysis``),
flashlight checkpoints (``flashlight_import``), the kenlm fixture
(``kenlm_fixture``), beam dumps (``rescore``), the synthetic corpus
(``synth_corpus``), the convergence soak (``soak``), the import of torch
ConvLM checkpoints (``convlm_import``) and the pseudo-label filters of
self-training (``pseudo_label``)."""
