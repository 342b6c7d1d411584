"""The serve slice of ``test_torch_serve_slice.py`` with baked int8 tables
served through FUSED-QMLP (``hash_q8_serve=True, serve_fuse_mlp=True``):
the proposal, nerfacto, SAM and ClipSeg heads each run their encode and
MLP as one call in both packages.  Same tolerances; a file of its own so
the frames render in parallel test workers."""
from samnerf_tpu_torch.fields import hash_encoding, nerfacto_field

from test_torch_serve_slice import check_frame, run_both


def test_serve_frame_matches_jax_fused_int8_tables(monkeypatch):
    calls = []
    fused = nerfacto_field.parity_hash_encode_qmlp

    def counted(*args, **kw):
        calls.append(len(args[0]))
        return fused(*args, **kw)

    def unfused(*args, **kw):
        raise AssertionError("an unfused encode ran on the fused serve path")

    monkeypatch.setattr(nerfacto_field, "parity_hash_encode_qmlp", counted)
    monkeypatch.setattr(hash_encoding.ParityHashEncoding, "forward", unfused)
    check_frame(*run_both(q8=True, fuse=True))
    # the SAM and ClipSeg heads stack their two pyramids into one call
    assert calls.count(1) > 0 and calls.count(2) > 0
