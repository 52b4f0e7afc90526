/* Client-side document text extraction (reference: ui/src/tools/pdf.ts,
 * ui/src/tools/doc.ts — which use pdfjs/WASM; this image cannot vendor
 * pdfjs offline, so both formats are parsed directly with the browser's
 * native DecompressionStream).
 *
 * extractDocx: OOXML .docx is a zip; walk the central directory, inflate
 *   word/document.xml (deflate-raw), pull the <w:t> runs per paragraph.
 * extractPdf: inflate /FlateDecode content streams (zlib deflate), then
 *   collect the text-showing operators Tj / TJ / ' / ". CID/Type0
 *   subset fonts (what modern word processors emit) are decoded through
 *   their /ToUnicode CMaps: objects are indexed (including /ObjStm
 *   object streams), each font's bfchar/bfrange map is parsed, the
 *   active font is tracked via the Tf operator, and shown strings
 *   (literal AND <hex>) are mapped code-by-code to Unicode. Fonts
 *   without a ToUnicode map fall back to the literal byte path.
 */
"use strict";

async function _inflate(bytes, format) {
  const ds = new DecompressionStream(format);
  const stream = new Blob([bytes]).stream().pipeThrough(ds);
  const buf = await new Response(stream).arrayBuffer();
  return new Uint8Array(buf);
}

/* ---------------- DOCX ---------------- */

function _zipEntries(view) {
  // find End Of Central Directory (scan backwards for PK\x05\x06)
  const u8 = new Uint8Array(view.buffer);
  let eocd = -1;
  for (let i = u8.length - 22; i >= 0; i--) {
    if (view.getUint32(i, true) === 0x06054b50) { eocd = i; break; }
  }
  if (eocd < 0) throw new Error("not a zip (no EOCD)");
  const count = view.getUint16(eocd + 10, true);
  let off = view.getUint32(eocd + 16, true);
  const entries = [];
  const dec = new TextDecoder();
  for (let n = 0; n < count; n++) {
    if (view.getUint32(off, true) !== 0x02014b50) break;
    const method = view.getUint16(off + 10, true);
    const csize = view.getUint32(off + 20, true);
    const nameLen = view.getUint16(off + 28, true);
    const extraLen = view.getUint16(off + 30, true);
    const commentLen = view.getUint16(off + 32, true);
    const localOff = view.getUint32(off + 42, true);
    const name = dec.decode(u8.subarray(off + 46, off + 46 + nameLen));
    entries.push({ name, method, csize, localOff });
    off += 46 + nameLen + extraLen + commentLen;
  }
  return entries;
}

async function _zipRead(view, entry) {
  const u8 = new Uint8Array(view.buffer);
  const lo = entry.localOff;
  if (view.getUint32(lo, true) !== 0x04034b50) throw new Error("bad local header");
  const nameLen = view.getUint16(lo + 26, true);
  const extraLen = view.getUint16(lo + 28, true);
  const start = lo + 30 + nameLen + extraLen;
  const raw = u8.subarray(start, start + entry.csize);
  if (entry.method === 0) return raw;
  if (entry.method === 8) return _inflate(raw, "deflate-raw");
  throw new Error("unsupported zip method " + entry.method);
}

function _xmlEntities(s) {
  return s
    .replace(/&lt;/g, "<").replace(/&gt;/g, ">").replace(/&quot;/g, '"')
    .replace(/&apos;/g, "'")
    .replace(/&#x([0-9a-fA-F]+);/g, (_, h) => String.fromCodePoint(parseInt(h, 16)))
    .replace(/&#(\d+);/g, (_, d) => String.fromCodePoint(+d))
    .replace(/&amp;/g, "&");
}

async function extractDocx(arrayBuffer) {
  const view = new DataView(arrayBuffer);
  const entry = _zipEntries(view).find(e => e.name === "word/document.xml");
  if (!entry) throw new Error("no word/document.xml (not a .docx?)");
  const xml = new TextDecoder().decode(await _zipRead(view, entry));
  const paras = [];
  for (const p of xml.split("</w:p>")) {
    const runs = [];
    // <w:t> runs carry the text; <w:tab/> and <w:br/> are whitespace
    const withBreaks = p.replace(/<w:tab\/>/g, "\t").replace(/<w:br\/>/g, "\n");
    const re = /<w:t(?:\s[^>]*)?>([\s\S]*?)<\/w:t>/g;
    let m;
    while ((m = re.exec(withBreaks)) !== null) runs.push(_xmlEntities(m[1]));
    if (runs.length) paras.push(runs.join(""));
  }
  return paras.join("\n");
}

/* ---------------- PDF ---------------- */

function _latin1(bytes) {
  let s = "";
  const CHUNK = 0x8000;
  for (let i = 0; i < bytes.length; i += CHUNK) {
    s += String.fromCharCode.apply(null, bytes.subarray(i, i + CHUNK));
  }
  return s;
}

function _pdfString(body) {
  // decode a PDF literal string body: escapes \n \r \t \b \f \( \) \\ \ddd
  let out = "", i = 0;
  while (i < body.length) {
    const c = body[i];
    if (c !== "\\") { out += c; i++; continue; }
    const n = body[i + 1];
    if (n === "n") out += "\n";
    else if (n === "r") out += "\r";
    else if (n === "t") out += "\t";
    else if (n === "b" || n === "f") out += "";
    else if (n >= "0" && n <= "7") {
      let oct = "", j = i + 1;
      while (j < body.length && oct.length < 3 && body[j] >= "0" && body[j] <= "7") oct += body[j++];
      out += String.fromCharCode(parseInt(oct, 8));
      i = j;
      continue;
    } else out += n || "";
    i += 2;
  }
  return out;
}

/* ToUnicode CMap parsing: bfchar/bfrange entries map font character
 * codes (1-2 bytes, per the codespacerange) to UTF-16BE strings. This
 * is the piece that makes CID/Type0-subset PDFs — i.e. most PDFs from
 * modern word processors — extractable (reference: ui/src/tools/pdf.ts
 * gets this from pdfjs). */
function _utf16hex(h) {
  if (h.length % 4 === 2) h = "00" + h; // tolerate 2-digit dst codes
  let out = "";
  for (let i = 0; i + 4 <= h.length; i += 4) {
    out += String.fromCharCode(parseInt(h.slice(i, i + 4), 16));
  }
  return out;
}

function _parseCMap(t) {
  const map = new Map();
  let codeBytes = 2;
  const cs = /begincodespacerange\s*<([0-9a-fA-F]+)>/.exec(t);
  if (cs) codeBytes = Math.max(1, Math.ceil(cs[1].length / 2));
  let m;
  const bc = /beginbfchar([\s\S]*?)endbfchar/g;
  while ((m = bc.exec(t)) !== null) {
    const pr = /<([0-9a-fA-F]+)>\s*<([0-9a-fA-F]+)>/g;
    let p;
    while ((p = pr.exec(m[1])) !== null) {
      map.set(parseInt(p[1], 16), _utf16hex(p[2]));
    }
  }
  const br = /beginbfrange([\s\S]*?)endbfrange/g;
  while ((m = br.exec(t)) !== null) {
    const rr = /<([0-9a-fA-F]+)>\s*<([0-9a-fA-F]+)>\s*(\[[\s\S]*?\]|<[0-9a-fA-F]+>)/g;
    let p;
    while ((p = rr.exec(m[1])) !== null) {
      const lo = parseInt(p[1], 16), hi = parseInt(p[2], 16);
      if (hi - lo > 0xffff) continue; // corrupt range guard
      if (p[3][0] === "[") {
        const items = p[3].match(/<[0-9a-fA-F]+>/g) || [];
        for (let c = lo; c <= hi && c - lo < items.length; c++) {
          map.set(c, _utf16hex(items[c - lo].slice(1, -1)));
        }
      } else {
        let base = p[3].slice(1, -1);
        if (base.length % 4 === 2) base = "00" + base;
        const prefix = _utf16hex(base.slice(0, -4));
        const start = parseInt(base.slice(-4), 16);
        for (let c = lo; c <= hi; c++) {
          map.set(c, prefix + String.fromCharCode(start + (c - lo)));
        }
      }
    }
  }
  return { map, codeBytes };
}

function _hexToRaw(hex) {
  hex = hex.replace(/[^0-9a-fA-F]/g, "");
  if (hex.length % 2) hex += "0"; // PDF pads a trailing odd digit
  let out = "";
  for (let i = 0; i < hex.length; i += 2) {
    out += String.fromCharCode(parseInt(hex.slice(i, i + 2), 16));
  }
  return out;
}

function _looksLikeTJ(content, i) {
  // a [ ... ] TJ array: peek for the closing ] followed by TJ
  const close = content.indexOf("]", i);
  if (close < 0 || close - i > 4096) return false;
  return /^\s*TJ/.test(content.slice(close + 1, close + 6));
}

function _pdfTextOps(content, cmapByName) {
  // collect arguments of Tj / ' / " and TJ arrays, in stream order,
  // decoding through the ACTIVE font's ToUnicode CMap (tracked via the
  // "/Name size Tf" operator) when it has one
  const parts = [];
  let inTJ = false, cmap = null;
  const emit = (raw) => {
    if (!cmap) { parts.push(raw); return; }
    const { map, codeBytes } = cmap;
    let out = "";
    for (let k = 0; k + codeBytes <= raw.length; k += codeBytes) {
      let code = 0;
      for (let b = 0; b < codeBytes; b++) {
        code = (code << 8) | (raw.charCodeAt(k + b) & 0xff);
      }
      const mapped = map.get(code);
      if (mapped !== undefined) out += mapped;
    }
    parts.push(out);
  };
  let i = 0;
  while (i < content.length) {
    const c = content[i];
    if (c === "(") {
      let depth = 1, j = i + 1, body = "";
      while (j < content.length && depth > 0) {
        const d = content[j];
        if (d === "\\") { body += d + (content[j + 1] || ""); j += 2; continue; }
        if (d === "(") depth++;
        else if (d === ")") { depth--; if (!depth) break; }
        if (depth > 0) body += d;
        j++;
      }
      // operator that follows decides whether it's shown text
      const after = content.slice(j + 1, j + 8);
      if (/^\s*(Tj|'|")/.test(after) || inTJ) emit(_pdfString(body));
      i = j + 1;
      continue;
    }
    if (c === "<" && content[i + 1] !== "<") {
      const close = content.indexOf(">", i);
      if (close > 0 && close - i < 65536) {
        const after = content.slice(close + 1, close + 8);
        if (/^\s*(Tj|'|")/.test(after) || inTJ) {
          emit(_hexToRaw(content.slice(i + 1, close)));
        }
        i = close + 1;
        continue;
      }
    }
    if (c === "/") {
      const tf = /^\/([^\s/<>[\]()]+)\s+[-\d.]+\s+Tf\b/.exec(
        content.slice(i, i + 64)
      );
      if (tf) {
        cmap = cmapByName.get(tf[1]) || null;
        i += tf[0].length;
        continue;
      }
    }
    if (c === "[") { inTJ = _looksLikeTJ(content, i); }
    if (c === "]") { inTJ = false; }
    if (c === "T" && (content[i + 1] === "d" || content[i + 1] === "D" || content[i + 1] === "*")) {
      parts.push("\n");
    }
    i++;
  }
  return parts.join("").replace(/\n{2,}/g, "\n");
}

async function extractPdf(arrayBuffer) {
  const u8 = new Uint8Array(arrayBuffer);
  const s = _latin1(u8);
  if (!s.startsWith("%PDF")) throw new Error("not a PDF");

  // 1. index "N G obj ... endobj" spans; inflate their streams
  const objs = new Map(); // num -> {dict, data: Uint8Array|null}
  const objRe = /(\d+)\s+\d+\s+obj\b/g;
  let om;
  while ((om = objRe.exec(s)) !== null) {
    const end = s.indexOf("endobj", om.index);
    if (end < 0) break;
    const span = s.slice(om.index, end);
    const sm = /stream\r?\n/.exec(span);
    const dict = sm ? span.slice(0, sm.index) : span;
    let data = null;
    if (sm) {
      const start = om.index + sm.index + sm[0].length;
      const se = s.indexOf("endstream", start);
      if (se >= 0) {
        data = u8.subarray(start, se);
        if (/\/FlateDecode/.test(dict)) {
          try { data = await _inflate(data, "deflate"); } catch { data = null; }
        }
      }
    }
    objs.set(+om[1], { dict, data });
    objRe.lastIndex = end;
  }

  // 2. expand /ObjStm object streams (PDF 1.5 packs small objects —
  // fonts, resources — into compressed streams; an ObjStm holds only
  // dict objects, never nested streams)
  let dictCorpus = s;
  for (const o of [...objs.values()]) {
    if (!/\/Type\s*\/ObjStm/.test(o.dict) || !o.data) continue;
    const n = +((/\/N\s+(\d+)/.exec(o.dict) || [])[1] || 0);
    const first = +((/\/First\s+(\d+)/.exec(o.dict) || [])[1] || 0);
    const body = _latin1(o.data);
    const header = body.slice(0, first).trim().split(/\s+/).map(Number);
    for (let k = 0; k < n; k++) {
      const onum = header[2 * k];
      const ooff = first + header[2 * k + 1];
      const oend = k + 1 < n ? first + header[2 * k + 3] : body.length;
      if (!Number.isFinite(onum)) break;
      objs.set(onum, { dict: body.slice(ooff, oend), data: null });
    }
    dictCorpus += "\n" + body;
  }

  // 3. per-font ToUnicode CMaps
  const cmapByFont = new Map(); // font obj num -> parsed cmap
  for (const [num, o] of objs) {
    const m = /\/ToUnicode\s+(\d+)\s+\d+\s+R/.exec(o.dict);
    if (!m) continue;
    const cm = objs.get(+m[1]);
    if (cm && cm.data) cmapByFont.set(num, _parseCMap(_latin1(cm.data)));
  }

  // 4. resource font names -> font objects (merged across pages; a
  // name collision across pages keeps the last — acceptable for a
  // lightweight parser, pdfjs scopes per page)
  const cmapByName = new Map();
  const fre = /\/Font\s*<<([\s\S]*?)>>/g;
  let fm;
  while ((fm = fre.exec(dictCorpus)) !== null) {
    const pr = /\/([^\s/<>[\]()]+)\s+(\d+)\s+\d+\s+R/g;
    let pm;
    while ((pm = pr.exec(fm[1])) !== null) {
      const cmap = cmapByFont.get(+pm[2]);
      if (cmap) cmapByName.set(pm[1], cmap);
    }
  }

  // 5. walk content streams in document order
  const texts = [];
  for (const o of objs.values()) {
    if (!o.data) continue;
    if (/\/Subtype\s*\/Image/.test(o.dict) || /\/FontFile/.test(o.dict)) continue;
    const content = _latin1(o.data);
    if (/begincmap|CIDInit/.test(content)) continue; // the CMaps themselves
    if (/\b(Tj|TJ|BT)\b/.test(content)) {
      texts.push(_pdfTextOps(content, cmapByName));
    }
  }
  const text = texts.join("\n").replace(/[ \t]+/g, " ").trim();
  if (!text) throw new Error("no extractable text (scanned PDF, or CID-encoded with no ToUnicode map?)");
  let junk = 0;
  for (const ch of text) {
    const code = ch.codePointAt(0);
    if (code < 0x20 && ch !== "\n" && ch !== "\r" && ch !== "\t") junk++;
  }
  if (junk / text.length > 0.3) {
    throw new Error("text appears CID-encoded without a usable ToUnicode map");
  }
  return text;
}

window.extractDocx = extractDocx;
window.extractPdf = extractPdf;
