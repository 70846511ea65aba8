"""Enters the multi-view cell's tiny sizes, which
``portbench/tests/test_portbench_multiview.py`` carries, in
``portbench/tests/conftest.py``'s ``TINY`` and ``TINY_PARAMS``. Pytest
imports this file before it collects any test under ``portbench/``, and
the tests read the two tables only when they run, so every test that calls
``tiny_cell`` finds them, whatever the order of the files."""

from portbench.tests import conftest as tests_conftest
from portbench.tests.test_portbench_multiview import MULTIVIEW_TINY, MULTIVIEW_TINY_PARAMS

tests_conftest.TINY["vitl16_ief512_mv4_224"] = MULTIVIEW_TINY
tests_conftest.TINY_PARAMS["multiview_train"] = MULTIVIEW_TINY_PARAMS
