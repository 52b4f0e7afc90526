"""The port's client-side document extraction (vectorsearch_tpu_torch/api
/static/doctools.js): the 6 scenarios of tests/test_doctools.py. No JS
runtime exists here, so, as there, the byte-level algorithms run through
test_doctools' step-for-step Python mirrors on real zip/zlib fixtures, and
the JS file is linted for the constants those mirrors depend on. The
port's static files must be the reference's, byte for byte, so that both
servers hand browsers the same extraction code."""
import os

import pytest

import test_doctools as mirrors

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATIC = os.path.join(ROOT, "vectorsearch_tpu_torch", "api", "static")
JAX_STATIC = os.path.join(ROOT, "vectorsearch_tpu", "api", "static")


def read(*parts):
    with open(os.path.join(*parts), "rb") as f:
        return f.read()


@pytest.fixture(autouse=True)
def port_static_is_the_reference():
    for name in ("doctools.js", "index.html"):
        assert read(STATIC, name) == read(JAX_STATIC, name), name


def test_docx_extraction_algorithm():
    mirrors.test_docx_extraction_algorithm()


def test_pdf_extraction_algorithm():
    mirrors.test_pdf_extraction_algorithm()


def test_cid_pdf_tounicode_extraction():
    assert mirrors.pdf_extract_cid(mirrors.make_cid_pdf()) == "HeeWorffl"


def test_cid_pdf_objstm_extraction():
    """Fonts and resources packed in a PDF 1.5 /ObjStm still resolve."""
    assert mirrors.pdf_extract_cid(mirrors.make_cid_pdf(objstm=True)) == "HeeWorffl"


def test_non_cid_pdf_still_extracts_via_literal_path():
    text = mirrors.pdf_extract_cid(mirrors.make_pdf())
    assert "Hello (PDF) world" in text and "Array" in text and "works" in text


def test_doctools_js_structure():
    src = read(STATIC, "doctools.js").decode()
    # balanced braces (a cheap syntax guard without a JS engine)
    assert src.count("{") == src.count("}")
    for needle in (
        "0x06054b50", "0x02014b50", "0x04034b50",  # EOCD, central dir, local header
        "deflate-raw", '"deflate"', "word/document.xml", "DecompressionStream",
        "extractPdf", "extractDocx",
        "beginbfchar", "beginbfrange", "ToUnicode", "ObjStm", "begincodespacerange",
    ):
        assert needle in src, needle
    html = read(STATIC, "index.html").decode()
    assert "doctools.js" in html and "extractPdf" in html and "extractDocx" in html
