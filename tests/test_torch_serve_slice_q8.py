"""The serve slice of ``test_torch_serve_slice.py`` with int8 tables
(``hash_q8_serve=True``, quantized on the fly at max scale in both
packages), in a file of its own so the two frames render in parallel
test workers."""
from test_torch_serve_slice import check_frame, run_both


def test_serve_frame_matches_jax_int8_tables():
    check_frame(*run_both(q8=True))
