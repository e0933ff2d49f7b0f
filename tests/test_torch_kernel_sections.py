"""``kernel_sections.py`` instruments pass A's bf16 chunk loop and nothing
else: the copy it builds on the card stamps each section of the loop, and
pass B and the entry points are left as they are.  On the CPU only the
source is made; nothing is built."""

import re

import kernel_sections as ks


def test_instrument_stamps_each_section_of_pass_a():
    src, ends = ks.instrument()
    stamps = re.findall(r'sec_\[(\d+)\] \+=', src)
    assert [int(i) for i in stamps] == list(range(len(ends)))
    assert 10 <= len(ends) <= ks.SLOTS
    for call in ('features_tc<false>', 'features_tc<true>', 'chain_rule_tc('):
        assert sum(call in end for end in ends) == 1, call
    assert all(re.match(r'favor_bwd\.cu:\d+ ', end) for end in ends)
    assert 'int read_sections(void* dst)' in src


def test_instrument_leaves_pass_b_alone():
    original = (ks.CSRC / 'favor_bwd.cu').read_text()
    src, _ = ks.instrument()
    start = 'template <class T, bool HL>\n__global__ void favor_bwd_b_kernel'
    body = lambda text: text[text.index(start):text.index('extern "C" {')]
    assert body(src) == body(original)
    assert 'sec_' not in body(src)
