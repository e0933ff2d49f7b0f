"""The port stands alone: no module of ``emo_disentanger_tpu_torch`` nor
``chip_smoke.py`` (nor the chip tools ``kernel_ab.py`` and
``kernel_sections.py``) imports JAX, flax, the JAX package or sklearn, and
its entry points refuse to fall back to the CPU silently."""

import ast
import re
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'emo_disentanger_tpu')
SOURCES = sorted((ROOT / 'emo_disentanger_tpu_torch').rglob('*.py')) + [
    ROOT / 'chip_smoke.py', ROOT / 'kernel_ab.py', ROOT / 'kernel_sections.py']


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize('path', SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported(path) if m.split('.')[0] in FORBIDDEN]
    assert not bad, f'{path.name} imports {bad}'


@pytest.mark.parametrize('path', SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_sklearn_imports(path):
    """The card's machine has no sklearn: the HookTheory split is written in
    numpy (``data/splits.py``), and no module of the port imports it."""
    bad = [m for m in _imported(path) if m.split('.')[0] == 'sklearn']
    assert not bad, f'{path.name} imports {bad}'


def test_sources_found():
    assert len(SOURCES) > 15


def test_entry_points_default_to_cuda(monkeypatch):
    from emo_disentanger_tpu_torch.core.vocab import Vocab
    from emo_disentanger_tpu_torch.infer.stage2_batch import Stage2BatchGenerator
    from emo_disentanger_tpu_torch.models import MusicPerformer
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    small = dict(n_token=12, n_layer=1, n_head=2, d_model=16, d_ff=32,
                 d_embed=16, favor_dims=8)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        MusicPerformer(**small)
    model = MusicPerformer(**small, device='cpu')
    omegas = model.draw_omegas(torch.Generator().manual_seed(0))
    vocab = Vocab({'Bar_None': 0}, {0: 'Bar_None'})
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        Stage2BatchGenerator(model, vocab, batch=2, omegas=omegas)
    Stage2BatchGenerator(model, vocab, batch=2, omegas=omegas, device='cpu')


def test_gpt2_entry_points_default_to_cuda(monkeypatch):
    """MusicGPT2 and both stage-2 generators raise without CUDA unless
    asked for the CPU."""
    from emo_disentanger_tpu_torch.core.vocab import Vocab
    from emo_disentanger_tpu_torch.infer.stage2 import Stage2Generator
    from emo_disentanger_tpu_torch.infer.stage2_batch import Stage2BatchGenerator
    from emo_disentanger_tpu_torch.models import MusicGPT2
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    small = dict(n_token=12, n_layer=1, n_head=2, d_model=16, d_ff=32,
                 d_embed=16)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        MusicGPT2(**small)
    model = MusicGPT2(**small, device='cpu').eval()
    vocab = Vocab({'Bar_None': 0}, {0: 'Bar_None'})
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        Stage2Generator(model, vocab, temp=1.0, top_p=0.9)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        Stage2BatchGenerator(model, vocab, batch=2)
    Stage2Generator(model, vocab, temp=1.0, top_p=0.9, device='cpu')
    Stage2BatchGenerator(model, vocab, batch=2, device='cpu')


def test_kernel_wrappers_never_fall_back():
    """The CUDA wrappers refuse non-CUDA tensors instead of running the
    plain version; only the public functions choose the plain version, and
    only for CPU tensors."""
    from emo_disentanger_tpu_torch.ops import flash_attention as fa
    from emo_disentanger_tpu_torch.ops import linear_attention as la
    from emo_disentanger_tpu_torch.ops import performer_decode as pd
    x = torch.zeros(2, 16, 8)
    om = torch.zeros(8, 16)
    with pytest.raises(ValueError, match='CUDA tensors'):
        la._favor_kmax_cuda(x, om)
    with pytest.raises(ValueError, match='CUDA tensors'):
        la._favor_fwd_cuda(x, x, x, om, torch.zeros(2, 1))
    with pytest.raises(ValueError, match='CUDA tensors'):
        pd._decode_layer_cuda(torch.zeros(2, 8), None, None, {}, om, None, 2)
    with pytest.raises(ValueError, match='CUDA tensors'):
        la._favor_bwd_a_cuda(x, x, x, x, om, torch.zeros(2, 1))
    with pytest.raises(ValueError, match='CUDA tensors'):
        la._favor_bwd_b_cuda(x, x, x, x, torch.zeros(2, 16), om, torch.zeros(2, 1))
    q = torch.zeros(1, 2, 64, 64)
    with pytest.raises(ValueError, match='CUDA tensors'):
        fa._flash_attention_cuda(q, q, q, 0.125)


def test_training_entry_points_default_to_cuda(monkeypatch):
    """``train_stage2.run`` and the CLI raise without CUDA unless asked for
    the CPU, before they read any file."""
    from emo_disentanger_tpu_torch.cli import train_stage2 as cli
    from emo_disentanger_tpu_torch.train import train_stage2
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        train_stage2.run({}, 'functional')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        cli.main(['-m', 'performer', '-c', 'pop1k7_pretrain.yaml',
                  '-r', 'functional'])


def test_stage1_entry_points_default_to_cuda(monkeypatch):
    """PlainTransformer, its builder and both stage-1 generators raise
    without CUDA unless asked for the CPU."""
    from emo_disentanger_tpu_torch.core.vocab import Vocab
    from emo_disentanger_tpu_torch.infer.stage1 import Stage1Generator
    from emo_disentanger_tpu_torch.infer.stage1_batch import Stage1BatchGenerator
    from emo_disentanger_tpu_torch.models import PlainTransformer
    from emo_disentanger_tpu_torch.train.train_stage1 import build_model_and_params
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    small = dict(n_layer=1, n_head=2, d_model=16, d_ff=32, d_embed=16)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        PlainTransformer(12, **small)
    config = {'model': {'d_word_embed': 16, 'pre_lnorm': True,
                        'decoder': {'n_layer': 1, 'n_head': 2, 'd_model': 16,
                                    'd_ff': 32, 'dropout': 0.1, 'mem_len': 0}}}
    vocab = Vocab({'Bar_None': 0}, {0: 'Bar_None'})
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        build_model_and_params(config, vocab)
    model = build_model_and_params(config, vocab, device='cpu')
    for gen in (Stage1Generator, Stage1BatchGenerator):
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            gen(model, vocab)
        gen(model, vocab, device='cpu')


def test_stage1_training_entry_points_default_to_cuda(monkeypatch):
    """``train_stage1.run`` and its CLI raise without CUDA unless asked for
    the CPU, before they read any file."""
    from emo_disentanger_tpu_torch.cli import train_stage1 as cli
    from emo_disentanger_tpu_torch.train import train_stage1
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        train_stage1.run({}, 'functional')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        cli.main(['-c', 'emopia_finetune.yaml', '-r', 'functional'])


def test_inference_entry_points_default_to_cuda(monkeypatch):
    """``run_stage1.run``, ``run_stage2.run`` and the two inference CLIs
    raise without CUDA unless asked for the CPU, before they read any
    file."""
    from emo_disentanger_tpu_torch.cli import inference_stage1, inference_stage2
    from emo_disentanger_tpu_torch.infer import run_stage1, run_stage2
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        run_stage1.run('none.yaml', 'functional', 'lead_sheet',
                       inference_params='none.pt', output_dir='none')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        run_stage2.run('none.yaml', 'functional', 'performer',
                       inference_params='none.pt', output_dir='none')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        inference_stage1.main(['-c', 'emopia_finetune.yaml', '-r', 'functional',
                               '-m', 'lead_sheet'])
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        inference_stage2.main(['-m', 'performer', '-c', 'emopia_finetune.yaml',
                               '-r', 'functional'])


# --------------------------------------------------------------- configs

CONFIGS = sorted(p.relative_to(ROOT / 'emo_disentanger_tpu' / 'configs')
                 for p in (ROOT / 'emo_disentanger_tpu' / 'configs').rglob('*.yaml'))


def test_config_copies_found():
    assert len(CONFIGS) == 8


@pytest.mark.parametrize('rel', CONFIGS, ids=str)
def test_config_copy_parses_as_the_jax_yaml(rel):
    """Each of the port's YAMLs (``emo_disentanger_tpu_torch/configs/``)
    gives the dict the JAX package's YAML of the same name gives."""
    from emo_disentanger_tpu.utils.io import load_yaml as jax_load
    from emo_disentanger_tpu_torch.utils.io import load_yaml
    copy = ROOT / 'emo_disentanger_tpu_torch' / 'configs' / rel
    assert load_yaml(str(copy)) == jax_load(str(ROOT / 'emo_disentanger_tpu' / 'configs' / rel))


@pytest.mark.parametrize('stage', ['1', '2'])
def test_bare_config_names_resolve_to_the_port_copies(stage):
    """A bare config name given to the port's CLIs resolves to the port's
    own copy, never to a file of the JAX package."""
    import importlib
    cli = importlib.import_module(f'emo_disentanger_tpu_torch.cli.train_stage{stage}')
    own = (ROOT / 'emo_disentanger_tpu_torch' / 'configs' / f'stage{stage}').resolve()
    for name in cli.KNOWN:
        path = Path(cli.resolve_config(name)).resolve()
        assert path.parent == own and path.name == name


# a record of which TPU kernel a CUDA kernel replaces names its source as
# file:lines; that is the one form a string of the port may name the JAX
# package's files in
_FILE_LINE = re.compile(r'emo_disentanger_tpu/[\w/]+\.py:\d+(-\d+)?')


def _strings(path):
    """The string constants of a source, docstrings left out."""
    tree = ast.parse(path.read_text(), str(path))
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            yield node.lineno, node.value


@pytest.mark.parametrize('path', SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_path_into_the_jax_package(path):
    """No module of the port, nor ``chip_smoke.py`` or the chip tools,
    builds a path into ``emo_disentanger_tpu/``: no string names the package
    as a path component, and none names a file of it other than as a
    file:line record."""
    bad = [(line, s) for line, s in _strings(path)
           if re.search(r'emo_disentanger_tpu(?!_torch)', s)
           and not _FILE_LINE.fullmatch(s)]
    assert not bad, f'{path.name} names the JAX package: {bad}'
