"""The port's run-to-completion bucket engine (serving/bucket.py) against
repro's BucketEngine, greedy and sampled, and ``sampling.split`` against
jax.random.split bit for bit.

The model is the f32, float-FFN smoke LM at repro's random init (seed 0),
carried over by ``params_from_jax``: in f32 the two packages' logits differ
by ~1e-6, far below the top-2 gaps of its greedy picks and of the sampled
picks' gumbel maxima at these few tokens. Also the launcher's
``--engine bucket``, in-process on the CPU.
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.configs.base import PrecisionPolicy as JaxPolicy  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.serving import BucketEngine as JaxBucketEngine  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import PrecisionPolicy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import sampling  # noqa: E402
from repro_torch.serving.bucket import BucketEngine  # noqa: E402

torch.set_num_threads(2)

F32 = dict(compute_dtype="float32", param_dtype="float32")


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config("stablelm-3b").replace(policy=JaxPolicy(), **F32)
    japi = jax_get_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    cfg = smoke_config("stablelm-3b").replace(policy=PrecisionPolicy(), **F32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return japi, jparams, get_model(cfg), params, cfg.vocab


def _drive(eng, prompts, max_news):
    rids = [eng.add_request(p, max_new=mn) for p, mn in zip(prompts, max_news)]
    res = eng.run()
    return [res[r] for r in rids]


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
def test_bucket_engine_equals_repro(models, temperature):
    """Three length groups, one larger than max_batch, mixed max_new (a
    group runs to its longest request)."""
    japi, jparams, api, params, vocab = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, n) for n in (5, 9, 5, 5, 12, 9)]
    max_news = [3, 6, 1, 4, 5, 2]
    kw = dict(max_batch=2, max_len=32, temperature=temperature, seed=3)
    want = _drive(JaxBucketEngine(japi, jparams, **kw), prompts, max_news)
    got = _drive(BucketEngine(api, params, **kw), prompts, max_news)
    assert got == want


def test_bucket_engine_validates_and_refuses_mesh(models):
    _, _, api, params, _ = models
    eng = BucketEngine(api, params, max_batch=2, max_len=16)
    for prompt, max_new in (([], 4), ([1, 2], 0), (list(range(14)), 4)):
        with pytest.raises(ValueError):
            eng.add_request(prompt, max_new=max_new)
    # a mesh serves on a `model` axis alone, as the reference does
    mesh = collections.namedtuple("Mesh", "axis_names shape")(("data", "model"),
                                                               {"data": 2, "model": 1})
    with pytest.raises(ValueError, match="serves on a `model` mesh only"):
        BucketEngine(api, params, mesh=mesh)


@pytest.mark.parametrize("seed,num", [(0, 2), (7, 3), (2 ** 31 - 1, 5)])
def test_split_equals_jax(seed, num):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num)).astype(np.int64)
    got = sampling.split(sampling.prng_key(seed), num).numpy()
    assert np.array_equal(got, want)


def test_categorical_shared_equals_jax():
    """One key for a whole (B, V) batch, f32 and bf16 logits."""
    key = jax.random.PRNGKey(11)
    logits = np.random.default_rng(1).standard_normal((4, 300)).astype(np.float32)
    for jdt, tdt in ((jax.numpy.float32, torch.float32), (jax.numpy.bfloat16, torch.bfloat16)):
        want = np.asarray(jax.random.categorical(key, jax.numpy.asarray(logits, jdt), axis=-1))
        got = sampling.categorical_shared(sampling.prng_key(11),
                                          torch.from_numpy(logits).to(tdt)).numpy()
        assert np.array_equal(got, want)


def test_launcher_bucket_engine():
    base = ["--smoke", "--device", "cpu", "--requests", "3", "--prompt-lens", "5,9",
            "--max-new", "3", "--engine", "bucket"]
    res = serve.main(base)
    assert sorted(res) == [0, 1, 2] and all(len(v) == 3 for v in res.values())
    with pytest.raises(SystemExit):                  # slot-engine-only flags
        serve.main(base + ["--interleave"])
