"""The XM-SfM front half end to end on the implicit route: the chain of
``tests/test_torch_sfm_chain.py`` with ``xm2_solve(implicit=True)`` (the
operator ``SchurQ``, its segment sums through the kernel's plain twin on
the host), held as there."""

from tests.test_torch_sfm_chain import chain, hold_xm2  # noqa: F401


def test_xm2_implicit_on_the_lifted_scene_agrees(chain):  # noqa: F811
    hold_xm2(chain, "implicit")
