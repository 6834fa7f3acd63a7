"""Work counted from shapes, against hand arithmetic."""

import json
import os

import pytest

from benchmark.core import peaks, work
from benchmark.models import llava_rerank as llava

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def _cfg(name):
    with open(os.path.join(CONFIGS, name + ".json")) as fh:
        return json.load(fh)


def test_cnn_forward_by_hand():
    model = _cfg("grasp-cnn-standard")["pipeline"]["model"]
    conv = (2 * 32 * 32 * 9 * 9 * 64 + 2 * 32 * 32 * 9 * 64 * 64
            + 2 * 16 * 16 * 9 * 64 * 128 + 2 * 16 * 16 * 9 * 128 * 128
            + 2 * 8 * 8 * 9 * 128 * 256 + 2 * 8 * 8 * 9 * 256 * 256)
    gate = 2 * 4 * 4 * 256
    dense = 2 * (256 * 256 + 256 * 128 + 128 * 64) + 2 * 64
    assert work.cnn_forward_flop(model, 1, 32) == conv + gate + dense
    assert work.cnn_forward_flop(model, 20, 32) == 20 * (conv + gate + dense)
    assert work.cnn_train_step_flop(model, 16, 32) == \
        3 * 16 * (conv + gate + dense)


def test_trie_counts_a_shared_prefix_once():
    rows = [[9, 9, 1, 2], [9, 9, 1, 3], [9, 9, 4]]
    # trie: 9 (1) 9 (2) 1 (3) 2 (4) 3 (4) 4 (3)
    assert work.distinct_tokens(rows) == 6
    assert work.shared_prefix_pairs(rows) == 1 + 2 + 3 + 4 + 4 + 3
    assert work.shared_prefix_pairs([[5] * 4]) == 10


def test_edt_bytes_read_once_written_once():
    assert work.minplus_bytes(1080, 1440, 1440) == 4 * 2 * 1080 * 1440
    assert work.minplus_bytes(10, 20, 5, qcol_numel=5) == 4 * (200 + 50 + 5)
    assert work.rowband_bytes(3, 1080, 1440) == 8 * 3 * 1080 * 1440


def test_rerank_of_the_7b_is_about_42_tflop():
    c = llava.model_config(_cfg("llava-v1.6-mistral-7b"))
    n_img = 2340
    prompts = [[c.image_token_index] * n_img + [1] + [10 * r + j + 3
                                                      for j in range(59)]
               for r in range(5)]
    fed = [p + [20000 + 10 * r + j for j in range(9)]
           for r, p in enumerate(prompts)]
    per_token = 2 * 32 * (4096 * (32 * 128 * 2 + 8 * 128 * 2)
                          + 3 * 4096 * 14336)
    assert llava.decoder_token_flop(c) == per_token
    distinct = 2341 + 5 * (59 + 9)
    assert work.distinct_tokens(fed) == distinct
    pairs = 2341 * 2342 // 2 + 5 * sum(range(2342, 2342 + 68))
    assert work.shared_prefix_pairs(fed) == pairs
    t = 577
    layer = 2 * t * (4 * 1024 ** 2 + 2 * 1024 * 4096) + 4 * t * t * 1024
    tile = (23 * layer + 2 * 576 * 3 * 14 * 14 * 1024
            + 2 * 576 * (1024 * 4096 + 4096 * 4096))
    assert llava.tower_flop(c, 5) == 5 * tile
    total = (5 * tile + distinct * per_token + 50 * 2 * 4096 * 32064
             + 4 * pairs * 32 * 128 * 32)
    got = llava.rerank_flop(c, prompts, fed, 5)
    assert got == pytest.approx(total)
    assert 40e12 < got < 43e12
    # about 42 ms at the bf16 peak
    assert 0.040 < got / peaks.BF16_FLOP_PER_S < 0.044


def test_anyres_tiles_of_a_production_frame():
    import numpy as np
    c = llava.model_config(_cfg("llava-v1.6-mistral-7b"))
    assert llava.n_tiles(c, np.zeros((1080, 1440, 3), np.uint8)) == 5


def test_least_time_takes_the_larger_bound():
    assert peaks.least_seconds(989e12, 0.0, "bfloat16") == pytest.approx(1)
    assert peaks.least_seconds(0.0, 3.35e12, "float32") == pytest.approx(1)
