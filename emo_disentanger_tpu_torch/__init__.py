"""emo_disentanger_tpu_torch — the PyTorch + CUDA port of ``emo_disentanger_tpu``.

The JAX package beside this one is the reference each module is held
against; this package imports none of it (nor JAX) and keeps its own copies
of what it needs.  Subpackage and module names mirror the JAX package's so
each counterpart is easy to find.

Subpackages
-----------
core      vocabulary construction (copied constants and ``Vocab``)
ops       FAVOR+ attention (forward and backward), the Performer decode
          layer, nucleus sampling; hand-written Hopper kernels under
          ``csrc/`` built by ``ops._build``
models    ``nn.Module`` Performer (training forward with dropout, loss,
          O(1)-state decode)
data      the stage-2 training dataset
train     schedule, optimizer and train/eval steps, checkpoints, the
          stage-2 driver ``train_stage2.run``
infer     rule tables and the batched stage-2 generator / server
cli       ``python -m emo_disentanger_tpu_torch.cli.train_stage2``
utils     device resolution, serving precision, logs, file IO

Entry points run on the GPU (``device='cuda'``) unless the caller passes
``device='cpu'``; on CPU tensors every kernel wrapper runs its plain PyTorch
version instead.
"""

__version__ = "0.1.0"
