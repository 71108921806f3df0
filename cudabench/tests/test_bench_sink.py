"""The FIFO round trip of the program's ``write_wav``: what the harness
drains from the FIFO equals the file the same call writes to disk."""

import numpy as np

from ame_tpu_torch.io.wav import write_wav
from cudabench.reference import wav
from cudabench.sink import FifoSink


def test_write_wav_round_trip(tmp_path):
    rng = np.random.default_rng(7)
    pcm = rng.integers(-32768, 32767, size=(300_001, 2)).astype(np.int16)
    write_wav(str(tmp_path / "file.wav"), pcm, 44100, 16)
    size = (tmp_path / "file.wav").stat().st_size
    sink = FifoSink(str(tmp_path), slot_bytes=size + 100, slots=2)
    try:
        sink.expect(1)
        write_wav(sink.path, pcm, 44100, 16)
        kept = bytes(sink.collect(timeout=30))
        sink.expect(None)
        write_wav(sink.path, pcm, 44100, 16)
        count = sink.collect(timeout=30)
        sink.expect(0)                    # a master larger than its slot
        write_wav(sink.path, np.concatenate([pcm, pcm[:60]]), 44100, 16)
        too_long = sink.collect(timeout=30)
    finally:
        sink.close()
    assert len(too_long) == 0
    assert kept == (tmp_path / "file.wav").read_bytes()
    assert count == len(kept)
    got, sr = wav.decode(kept)
    assert sr == 44100 and np.array_equal(got, pcm)
    assert wav.encode(pcm, 44100) == kept


def test_a_call_that_never_writes_is_released(tmp_path):
    sink = FifoSink(str(tmp_path), slot_bytes=1024, slots=1)
    try:
        sink.expect(0)
        for _ in range(600):
            sink.release()
            try:
                assert len(sink.collect(timeout=0.1)) == 0
                break
            except Exception:
                continue
        else:
            raise AssertionError("the reader never ended")
        sink.expect(None)
        write_wav(sink.path, np.zeros((10, 2), np.int16), 44100, 16)
        assert sink.collect(timeout=30) == 84
    finally:
        sink.close()
