"""favor_roofline_pct: the FAVOR+ kernels' share of their roofline.  The
least time of the FAVOR+ forward and backward of every layer at the cell's
shapes (``work.favor_train_seconds``, the algorithm's FLOPs and bytes at
bf16) over the device time of the kernels that do that work: the key max,
the forward and both backward passes, in either layout."""

KERNELS = ('favor_kmax_kernel', 'favor_fwd_kernel', 'favor_bwd_a_kernel',
           'favor_bwd_b_kernel')


def read(ctx):
    r, cfg, c = ctx['reading'], ctx['cfg'], ctx['counts']
    spent = r.kernel_seconds(KERNELS)
    if spent <= 0:
        return None
    least = ctx['work'].favor_train_seconds(cfg, c['batch'], c['seq_len'],
                                            cfg['training']['compute_dtype'])
    return 100.0 * least * r.steps / spent
