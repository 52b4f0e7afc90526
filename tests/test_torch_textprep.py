"""The port's text preparation (vectorsearch_tpu_torch/engine/textprep.py,
reference server/format.go): the 14 scenarios of tests/test_textprep.py,
each answered by the port's module and by the JAX package's alike."""
import vectorsearch_tpu.engine.textprep as jax_textprep
import vectorsearch_tpu_torch.engine.textprep as port_textprep


def both(fn_name, *args):
    port = getattr(port_textprep, fn_name)(*args)
    assert port == getattr(jax_textprep, fn_name)(*args)
    return port


def flatten(value):
    return both("flatten", value)


def split(prefix, text, ctx):
    return both("split", prefix, text, ctx)


class TestFlatten:
    def test_null(self):
        assert flatten(None) == "null."

    def test_bools(self):
        assert flatten(True) == "true."
        assert flatten(False) == "false."

    def test_string_normalization(self):
        # CRs removed, blank runs collapsed, trailing dot ensured
        assert flatten("hello\r\nworld") == "hello\nworld."
        assert flatten("a\n\n\nb") == "a\nb."
        assert flatten("  padded  ") == "padded."
        assert flatten("ends.") == "ends."

    def test_numbers_shortest_float32(self):
        # Go strconv.FormatFloat(v, 'f', -1, 32)
        assert flatten(3.0) == "3"
        assert flatten(0.1) == "0.1"
        assert flatten(42) == "42"
        assert flatten(-2.5) == "-2.5"

    def test_array_one_line_per_item(self):
        assert flatten(["a", "b"]) == "a.\nb."

    def test_map_sorted_keys_prefixed(self):
        assert flatten({"b": "two", "a": "one"}) == "a: one.\nb: two."

    def test_nested_map_lines_all_prefixed(self):
        assert flatten({"k": ["x", "y"]}) == "k: x.\nk: y."

    def test_deep_nesting(self):
        assert flatten({"outer": {"inner": 1.5}}) == "outer: inner: 1.5"


class TestSplit:
    def test_single_small_section(self):
        assert split("", "one two three", 1000) == [" one two three"]

    def test_prefix_on_each_section(self):
        # maxWords = ((40*9)//10)//4 = 9
        out = split("Doc. ", "\n".join(["w1 w2 w3 w4 w5"] * 4), 40)
        assert len(out) > 1 and all(s.startswith("Doc. ") for s in out)

    def test_negative_ctx_every_line_is_a_section(self):
        # the noop provider's ctx: each line a section, and a non-empty
        # prefix flushed once first (format.go:96-105)
        assert split("p. ", "l1\nl2", -(2**60)) == ["p. ", "p.  l1", "p.  l2"]

    def test_empty_prefix_negative_ctx(self):
        assert split("", "l1\nl2", -(2**60)) == [" l1", " l2"]

    def test_word_budget_respected(self):
        out = split("", "\n".join(f"word{i} extra" for i in range(50)), 100)  # maxWords 22
        assert all(len(section.split()) <= 24 for section in out)


def test_document_prefix():
    assert both("document_prefix", "") == ""
    assert both("document_prefix", "Title") == "Title. "
    assert both("document_prefix", "Title.") == "Title. "
    assert both("document_prefix", "  Spaced  ") == "Spaced. "
