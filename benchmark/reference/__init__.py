"""The benchmark's plain reference: the configurations' mathematics in plain
PyTorch, float32 on the tensor side (float64 for the frontend and the CTC
loss), TF32 off, with no kernel, cache or batching trick of the program.

It imports nothing of the program under test (``wav2letter_tpu_torch``) nor
the JAX package. It is handed the same inputs as the program: the batches,
the seeded weights and the seed of each step; it works out again everything
the program derives from them (features, masks, step seeds, learning rates).

Modules:
  numerics  precision settings, and the lower-precision control (fp8 operands)
  frontend  MFSC features, local CMVN, SpecAugment
  model     the arch lines the configurations use: the TDS and transformer stacks
  ctc       the CTC loss
  optim     learning rate, step seeds, clip, SGD and Adam
  steps     training steps and serving forwards, in blocks of rows
"""
