"""emo_disentanger_tpu_torch — the PyTorch + CUDA port of ``emo_disentanger_tpu``.

The JAX package beside this one is the reference each module is held
against; this package imports none of it (nor JAX) and keeps its own copies
of what it needs.  Subpackage and module names mirror the JAX package's so
each counterpart is easy to find.

Subpackages
-----------
core      vocabulary construction, key/degree theory, events and
          quantization grids (copies of the JAX package's)
ops       FAVOR+ attention (forward and backward), the Performer decode
          layer, flash attention, the KV-cache decode attentions, nucleus
          sampling; hand-written Hopper kernels under ``csrc/`` built by
          ``ops._build``
models    ``nn.Module`` stage-1 Transformer-XL (``PlainTransformer``) and
          stage-2 Performer and GPT-2 (training forward with dropout, loss,
          decode)
data      the stage-1 and stage-2 training datasets; the SMF reader and
          writer ``midi_io``
train     schedule, optimizer and train/eval steps, checkpoints, the
          drivers ``train_stage1.run`` and ``train_stage2.run``
infer     rule tables, the stage-1 and stage-2 generators and servers, the
          reference-exact replays; the drivers ``run_stage1.run`` and
          ``run_stage2.run``, the ``_roman.txt`` contract (``pipeline``),
          MIDI rendering (``convert2midi``), ``metrics``, ``audio``
parallel  the device mesh over ``torch.distributed`` ranks (``mesh``:
          ('dp', 'tp') or ('dcn', 'dp', 'tp'), batch sharding, the data
          axes' collectives) and tensor-parallel placement
          (``sharding_rules``: the rule table, ``placement_report``,
          ``shard_params`` and the collectives of a sharded projection)
cli       train-stage1, train-stage2, infer-stage1, infer-stage2,
          events2words and evaluate, dispatched by
          ``python -m emo_disentanger_tpu_torch <command>``
utils     device resolution, serving precision, logs, file IO;
          ``profiling`` (``trace`` over ``torch.profiler``, the program's
          spans and counters) and ``debug`` (``checked_train_step``,
          ``assert_all_finite``)

Entry points run on the GPU (``device='cuda'``) unless the caller passes
``device='cpu'``; on CPU tensors every kernel wrapper runs its plain PyTorch
version instead.
"""

__version__ = "0.1.0"
