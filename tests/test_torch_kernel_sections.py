"""``kernel_sections.py`` instruments the bf16 chunk loops of the forward
and of both backward passes and nothing else: the copies it builds on the
card stamp each section of the forward's, pass A's and pass B's loop, every
added statement runs only under bf16 (``TC``), and the f32 paths and the
entry points are left as they are.  Its ``--kmax`` copies change only the
bf16 key max's chunks a block; its ``--cla`` copies stamp the composed
op's three kernels, or change only their warps a block.  On the CPU only
the sources are made; nothing is built."""

import re

import pytest

import kernel_sections as ks

START = 'template <class T, bool HL>\n__global__ void '


def _kernel(text, name):
    """The source of kernel ``name``, up to the next template."""
    k0 = text.index(START + name)
    return text[k0:text.index('\ntemplate <', k0 + len(START))]


def _stamps(text):
    return [int(i) for i in re.findall(r'sec_\[(\d+)\] \+=', text)]


def test_instrument_stamps_each_section_of_pass_a():
    src, ends = ks.instrument()
    ends = ends['favor_bwd_a']
    assert _stamps(_kernel(src, 'favor_bwd_a_kernel')) == list(range(len(ends)))
    assert 10 <= len(ends) <= ks.SLOTS
    for call in ('features_tc<false>', 'features_tc<true>', 'chain_rule_tc('):
        assert sum(call in end for end in ends) == 1, call
    assert all(re.match(r'favor_bwd\.cu:\d+ ', end) for end in ends)
    assert 'int read_sections(void* dst)' in src


def test_instrument_stamps_each_section_of_pass_b():
    src, ends = ks.instrument()
    ends = ends['favor_bwd_b']
    body = _kernel(src, 'favor_bwd_b_kernel')
    assert _stamps(body) == list(range(len(ends)))
    assert 10 <= len(ends) <= ks.SLOTS
    for call in ('features_tc<true>', 'features_tc<false>', 'chain_rule_tc('):
        assert sum(call in end for end in ends) == 1, call
    assert 'g_sections[1][blockIdx.x][i] = sec_[i]' in body
    assert 'g_sections[0]' in _kernel(src, 'favor_bwd_a_kernel')
    # each section's line number names the line of the repository's source
    lines = (ks.CSRC / 'favor_bwd.cu').read_text().split('\n')
    for end in ends:
        no, text = re.match(r'favor_bwd\.cu:(\d+) (.{1,24}) \(', end).groups()
        assert lines[int(no) - 1].strip().startswith(text), end


def test_instrument_leaves_f32_path_and_entry_points_alone(source='favor_bwd.cu'):
    """Without the lines it adds, the copy is the original: the f32 path
    and the extern "C" entry points are as they were, and every added
    statement in a kernel runs only under ``TC``, the bf16 instantiation."""
    original = (ks.CSRC / source).read_text()
    src, _ = ks.instrument(source)
    added = [l for l in src.split('\n') if 'sec_' in l or 'g_sections' in l]
    assert added and all('TC' in l for l in added if 'sec_' in l)
    read = ('int read_sections(void* dst) {\n  return (int)cudaMemcpyFromSymbol(dst, '
            'g_sections, sizeof(g_sections));\n}\n')
    assert src.count(read) == 1
    kept = '\n'.join(l for l in src.replace(read, '').split('\n') if l not in added)
    assert kept == original
    entry = lambda text: text[text.index('extern "C" {'):]
    assert entry(src).replace(read, '') == entry(original)


def test_instrument_stamps_each_section_of_the_forward():
    """The forward's bf16 loop is stamped at its loads, both ||x||^2 and
    both feature maps, the scores, the denominator, the numerator and the
    state update; the key-max kernel of the same file is not touched."""
    src, ends = ks.instrument('favor_fwd.cu')
    assert list(ends) == ['favor_fwd']
    ends = ends['favor_fwd']
    body = _kernel(src, 'favor_fwd_kernel')
    assert _stamps(body) == list(range(len(ends)))
    assert 10 <= len(ends) <= ks.SLOTS
    for call in ('row_sq_tc(', 'features_tc<false>', 'features_tc<true>'):
        assert sum(call in end for end in ends) == (2 if call == 'row_sq_tc(' else 1), call
    assert 'g_sections[0][blockIdx.x][i] = sec_[i]' in body
    assert 'sec_' not in _kernel(src, 'favor_kmax_kernel')
    assert 'int read_sections(void* dst)' in src
    lines = (ks.CSRC / 'favor_fwd.cu').read_text().split('\n')
    for end in ends:
        no, text = re.match(r'favor_fwd\.cu:(\d+) (.{1,24}) \(', end).groups()
        assert lines[int(no) - 1].strip().startswith(text), end


def test_instrument_leaves_forward_f32_path_and_entry_points_alone():
    """As above, for the forward's source."""
    test_instrument_leaves_f32_path_and_entry_points_alone('favor_fwd.cu')


@pytest.mark.parametrize('name, per, regs', ks.KMAX_VARIANTS)
def test_kmax_variant_fixes_chunks_a_block(name, per, regs):
    """A ``--kmax`` copy differs from ``favor_fwd.cu`` only in the key
    max's two rules: ``launch_kmax``'s chunks a block, replaced by a fixed
    count under bf16 (f32 keeps one chunk a block), and, for the ``s``
    copy, where omega is kept, replaced by shared memory at every width."""
    original = (ks.CSRC / 'favor_fwd.cu').read_text().split('\n')
    src = ks.kmax_variant(per, regs).split('\n')
    assert len(src) == len(original)
    diff = [(a.strip(), b.strip()) for a, b in zip(original, src) if a != b]
    want = [] if regs else [(ks.KMAX_REGS, 'return false;')]
    want.append((ks.KMAX_RULE, f'if (TC) per = {per};'))
    assert diff == want and name.rstrip('s') == str(per)
    launch = '\n'.join(original)
    launch = launch[launch.index('int launch_kmax('):launch.index('int launch_fwd(')]
    assert ks.KMAX_RULE in launch


def _cla_kernel(text, name):
    """The source of the non-template kernel ``name`` of linear_attn.cu."""
    k0 = text.index('__global__ void ' + name)
    return text[k0:text.index('\n}\n', k0) + 3]


@pytest.mark.parametrize('name, n_sections',
                         [('cla_fwd', 5), ('cla_bwd_a', 8), ('cla_bwd_b', 6)])
def test_instrument_stamps_each_section_of_the_cla_passes(name, n_sections):
    """``--cla`` stamps every barrier of the forward's and each backward
    pass's chunk loop (loads, products, row reductions, the state update),
    each section's line naming the repository's source: the forward's
    loads, scores, denominator, numerator and state update."""
    src, ends = ks.instrument('linear_attn.cu')
    assert list(ends) == ['cla_bwd_b', 'cla_bwd_a', 'cla_fwd']
    body = _cla_kernel(src, f'{name}_kernel')
    assert _stamps(body) == list(range(n_sections)) == list(range(len(ends[name])))
    p = list(ks.KERNELS['linear_attn.cu']).index(name)
    assert f'g_sections[{p}][blockIdx.x][i] = sec_[i]' in body
    lines = (ks.CSRC / 'linear_attn.cu').read_text().split('\n')
    for end in ends[name]:
        no, text = re.match(r'linear_attn\.cu:(\d+) (.{1,24}) \(', end).groups()
        assert lines[int(no) - 1].strip().startswith(text), end
        assert text.startswith('__syncthreads();'), end


def test_instrument_leaves_cla_source_and_entry_points_alone():
    """Without the lines it adds, the copy of linear_attn.cu is the
    original, entry points included."""
    original = (ks.CSRC / 'linear_attn.cu').read_text()
    src, _ = ks.instrument('linear_attn.cu')
    read = ('int read_sections(void* dst) {\n  return (int)cudaMemcpyFromSymbol(dst, '
            'g_sections, sizeof(g_sections));\n}\n')
    added = [l for l in src.split('\n') if 'sec_' in l or 'g_sections' in l]
    assert added and all('true' in l for l in added if 'sec_' in l)
    kept = '\n'.join(l for l in src.replace(read, '').split('\n') if l not in added)
    assert kept == original


@pytest.mark.parametrize('warps', ks.CLA_WARPS)
def test_cla_variant_changes_only_the_warps_a_block(warps):
    """A ``--cla`` timing copy differs from ``linear_attn.cu`` only in the
    composed op's threads a block, and the source launches the forward and
    both passes with that constant."""
    original = (ks.CSRC / 'linear_attn.cu').read_text()
    src = ks.cla_variant(warps).split('\n')
    diff = [(a.strip(), b.strip()) for a, b in zip(original.split('\n'), src) if a != b]
    want = [] if 32 * warps == 512 else [
        (ks.CLA_THREADS, f'constexpr int CLA_THREADS = {32 * warps};')]
    assert len(src) == len(original.split('\n')) and diff == want
    assert original.count('<<<BH, CLA_THREADS, smem') == 3
