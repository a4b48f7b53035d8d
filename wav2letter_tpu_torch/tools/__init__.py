"""Host-side tools of the port: n-gram LM training and binary conversion
(``ngram_lm``) and beam dumps (``rescore``)."""
