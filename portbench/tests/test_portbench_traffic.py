"""The seeded traffic: the same seed gives the same work, and every
seed the same sizes."""

from portbench.traffic import generate


def test_batches_repeat_per_seed_and_keep_sizes_across_seeds():
    a = generate.synthetic_text(49152, 2048, 1, 2 ** 31 + 11, 4)
    b = generate.synthetic_text(49152, 2048, 1, 2 ** 31 + 11, 4)
    c = generate.synthetic_text(49152, 2048, 1, 5, 4)
    assert (a == b).all()
    assert (a != c).any()
    assert a.shape == c.shape == (1, 2049)
    assert a.min() >= 0 and a.max() < 49152


def test_synthetic_text_is_the_programs_stream():
    from repro_torch.train import SyntheticText

    ours = generate.synthetic_text(49152, 64, 2, 2 ** 31 + 3, 7)
    theirs = SyntheticText(49152, 64, 2, seed=2 ** 31 + 3).batch(7)
    assert (ours == theirs).all()
