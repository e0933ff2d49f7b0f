from .checkpoint import (
    CKPT_RE, checkpoint_name, gc_checkpoints, latest_checkpoint,
    load_checkpoint, save_checkpoint,
)
from .schedule import warmup_cosine
from .trainer import (
    Optimizer, OptimizerConfig, accuracy_sums, finalize_accuracy,
    make_eval_step, make_optimizer, make_segmented_train_step,
    make_train_step, stage1_loss_fn, stage2_performer_loss_fn,
)
