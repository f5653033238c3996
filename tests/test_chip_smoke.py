"""chip_smoke.py rehearsed on the CPU: every phase at a tiny size (the
same functions the card runs at full size), and the refusals that keep a
run without a GPU from printing a result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = [
    (chip_smoke.phase_lpcm, dict(seconds=0.4, batch_frames=8)),
    (chip_smoke.phase_opus, dict(seconds=0.4, batch_frames=8, reps=2)),
    (chip_smoke.phase_limiter, dict(seconds=0.4, batch_frames=8)),
    (chip_smoke.phase_binaural, dict(seconds=0.3, batch_frames=4)),
    (chip_smoke.phase_mp4_seek, dict(seconds=0.4, start_sec=0.1,
                                     batch_frames=4)),
    (chip_smoke.phase_serving, dict(seconds=0.3, n_pcm=2, batch_frames=4)),
    (chip_smoke.phase_aac_filterbank, dict(frames=8, lanes=3)),
    (chip_smoke.phase_resampler, dict(seconds=0.1, channels=3)),
    (chip_smoke.phase_player, dict(seconds=0.2, batch_frames=4)),
    (chip_smoke.phase_multi_device, dict(n_devices=4, seconds=0.3,
                                         batch_frames=4)),
]


@pytest.mark.parametrize("phase,sizes", TINY,
                         ids=[p.__name__ for p, _ in TINY])
def test_phase_tiny(phase, sizes, capsys):
    rec = phase(**sizes)
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("PHASE ")][-1]
    assert json.loads(line[len("PHASE "):]) == json.loads(
        json.dumps(rec, default=float))


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert "needs a GPU" in str(e.value.code)
    assert '"ok"' not in capsys.readouterr().out


def test_refuses_outside_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "checkout" in res.stderr


def test_loop_units_keeps_one_trim():
    """The looped Opus content: n units, the pre-skip trim only on the
    first, every unit a copy of one of the sample's."""
    import vectors
    from iamf_tpu.core.batch_decoder import BatchedStreamDecoder

    with open(chip_smoke.OPUS_SAMPLE, "rb") as f:
        sample = f.read()
    desc, units = vectors.split_into_units(sample)
    looped = vectors.loop_units(sample, 40)
    d2, u2 = vectors.split_into_units(looped)
    assert d2 == desc and len(u2) == 40
    assert u2[0] == units[0] and set(u2[1:]) <= set(units[1:])
    dec = BatchedStreamDecoder(looped, sound_system=9, batch_frames=8)
    assert dec.n_frames == 40
    assert dec.lead == sum(t[0] for t in dec.trims) > 0
    assert all(t == (0, 0) for t in dec.trims[1:])
