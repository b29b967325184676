/* sofa board — self-contained chart + CSV utilities.
 *
 * The reference board depends on CDN-hosted d3/Highcharts/Plotly
 * (sofaboard/index.html); profiling hosts are often air-gapped, so this
 * board ships its own small canvas renderer instead: zoomable/pannable
 * scatter+line timeline with legend toggles and nearest-point tooltips.
 */

"use strict";

/* ---------- CSV ---------- */
function parseCSV(text) {
  const lines = text.split(/\r?\n/).filter((l) => l.length > 0);
  if (!lines.length) return { header: [], rows: [] };
  const header = splitCSVLine(lines[0]);
  const rows = lines.slice(1).map(splitCSVLine);
  return { header, rows };
}
function splitCSVLine(line) {
  const out = [];
  let cur = "", inQ = false;
  for (let i = 0; i < line.length; i++) {
    const c = line[i];
    if (inQ) {
      if (c === '"' && line[i + 1] === '"') { cur += '"'; i++; }
      else if (c === '"') inQ = false;
      else cur += c;
    } else if (c === '"') inQ = true;
    else if (c === ",") { out.push(cur); cur = ""; }
    else cur += c;
  }
  out.push(cur);
  return out;
}
function csvColumn(csv, name) {
  const i = csv.header.indexOf(name);
  return i < 0 ? [] : csv.rows.map((r) => r[i]);
}
async function fetchCSV(path) {
  const resp = await fetch(path);
  if (!resp.ok) throw new Error(path + ": " + resp.status);
  return parseCSV(await resp.text());
}

/* ---------- columnar series data ----------
 * report.js and the LOD tiles ship series data as columnar arrays
 * {x:[],y:[],d:[],names:[table],ni:[codes]} — names are interned into a
 * string table + int codes (smaller payload + one C-encoder dumps
 * server-side); the renderer works on point objects, so decode once at
 * load.  Legacy per-point arrays and plain name arrays pass through. */
function pointsFromColumnar(data) {
  if (!data) return [];
  if (Array.isArray(data)) return data;
  const xs = data.x || [], ys = data.y || [], ds = data.d || [];
  const table = data.names || null, codes = data.ni || null;
  const plain = data.name || [];
  const out = new Array(xs.length);
  for (let i = 0; i < xs.length; i++) {
    const nm = table ? (table[codes[i]] || "") : (plain[i] || "");
    out[i] = { x: xs[i], y: ys[i], name: nm, d: ds[i] || 0 };
  }
  return out;
}

/* ---------- LOD tiles ----------
 * Deep zoom fetches pre-gzipped columnar tiles from the pyramid the
 * pipeline wrote under _tiles/ (tiles.py).  The viz server
 * negotiates Content-Encoding so the browser inflates transparently; a
 * dumb static host hands back raw gzip bytes, which are inflated here via
 * DecompressionStream (the magic-byte check tells the two apart). */
async function fetchGzJSON(path) {
  const resp = await fetch(path);
  if (!resp.ok) throw new Error(path + ": " + resp.status);
  const buf = new Uint8Array(await resp.arrayBuffer());
  if (buf.length > 1 && buf[0] === 0x1f && buf[1] === 0x8b) {
    const stream = new Blob([buf]).stream()
      .pipeThrough(new DecompressionStream("gzip"));
    return JSON.parse(await new Response(stream).text());
  }
  return JSON.parse(new TextDecoder().decode(buf));
}

/* Tiles are fixed-point integer columnar: x delta-encoded at sx
 * resolution, y/d scaled ints, names interned (tiles.py) —
 * integers encode and gzip far tighter than floats. */
function pointsFromTile(t) {
  if (!t.xd) return pointsFromColumnar(t);
  const out = new Array(t.xd.length);
  const table = t.names || [], codes = t.ni || [];
  let acc = 0;
  for (let i = 0; i < t.xd.length; i++) {
    acc += t.xd[i];
    out[i] = {
      x: acc * t.sx,
      y: (t.yv[i] || 0) * t.sy,
      name: table[codes[i]] || "",
      d: (t.dv[i] || 0) * t.sd,
    };
  }
  return out;
}

class TileLoader {
  constructor(manifest, base) {
    this.manifest = manifest || { series: {} };
    this.base = base || this.manifest.dir || "_tiles";
    this.cache = new Map(); // url -> Promise<tile|null>; 404 = empty window
  }
  entry(name) { return (this.manifest.series || {})[name]; }
  levelFor(ent, span) {
    // deepest level whose tile windows are ~the view span (1-4 tiles
    // visible); clamped to the pyramid's real depth
    const domain = Math.max(ent.x1 - ent.x0, 1e-12);
    const lvl = Math.ceil(Math.log2(Math.max(domain / Math.max(span, 1e-12), 1))) + 1;
    return Math.max(0, Math.min(ent.levels - 1, lvl));
  }
  tile(ent, name, level, n) {
    const url = this.base + "/" + (ent.path || name) + "/" + level + "/" + n + ".json.gz";
    if (!this.cache.has(url)) {
      this.cache.set(url, fetchGzJSON(url).catch(() => null));
    }
    return this.cache.get(url);
  }
  async range(name, x0, x1) {
    // every tile overlapping [x0, x1] at the view-appropriate level,
    // decoded and concatenated into renderer points (x-ordered: tiles are
    // ordered and points within a tile are x-sorted)
    const ent = this.entry(name);
    if (!ent) return null;
    const level = this.levelFor(ent, x1 - x0);
    const domain = Math.max(ent.x1 - ent.x0, 1e-12);
    const nt = Math.pow(2, level);
    const clamp = (v) => Math.max(0, Math.min(nt - 1, v));
    const lo = clamp(Math.floor(((x0 - ent.x0) / domain) * nt));
    const hi = clamp(Math.floor(((x1 - ent.x0) / domain) * nt));
    const jobs = [];
    for (let n = lo; n <= hi && jobs.length < 16; n++) {
      jobs.push(this.tile(ent, name, level, n));
    }
    const tiles = await Promise.all(jobs);
    const pts = [];
    let exact = true, count = 0;
    for (const t of tiles) {
      if (!t) continue; // sparse pyramid: missing tile = empty window
      exact = exact && !!t.exact;
      count += t.count || 0;
      for (const p of pointsFromTile(t)) pts.push(p);
    }
    return { level: level, points: pts, exact: exact, count: count };
  }
}

/* ---------- number formatting ---------- */
function fmt(v) {
  if (!isFinite(v)) return "-";
  const a = Math.abs(v);
  if (a >= 1e12) return (v / 1e12).toFixed(2) + "T";
  if (a >= 1e9) return (v / 1e9).toFixed(2) + "G";
  if (a >= 1e6) return (v / 1e6).toFixed(2) + "M";
  if (a >= 1e3) return (v / 1e3).toFixed(2) + "k";
  if (a >= 1 || a === 0) return v.toFixed(3).replace(/\.?0+$/, "");
  if (a >= 1e-3) return (v * 1e3).toFixed(3) + "m";
  if (a >= 1e-6) return (v * 1e6).toFixed(2) + "u";
  return (v * 1e9).toFixed(2) + "n";
}

/* ---------- Timeline chart ---------- */
class Timeline {
  constructor(canvas, opts) {
    this.canvas = canvas;
    this.ctx = canvas.getContext("2d");
    this.series = []; // {name,title,color,kind,data:[{x,y,name,d}],visible}
    this.opts = Object.assign({ logY: false, xLabel: "time (s)", yLabel: "" }, opts || {});
    this.margin = { l: 64, r: 16, t: 10, b: 34 };
    this.tooltip = null;
    this._bindEvents();
  }
  setSeries(series) {
    this.series = series.map((s) => {
      const pts = pointsFromColumnar(s.data);
      // overview = the report.js level-0 data; deep zoom swaps s.data for
      // tile points and resetView restores this
      return Object.assign({ visible: true }, s, { data: pts, overview: pts });
    });
    this.resetView();
  }
  setData(name, pts) {
    for (const s of this.series) {
      if (s.name === name) s.data = pts;
    }
  }
  resetView() {
    for (const s of this.series) {
      if (s.overview) s.data = s.overview;
    }
    let x0 = Infinity, x1 = -Infinity, y0 = Infinity, y1 = -Infinity;
    for (const s of this.series) {
      if (!s.visible) continue;
      for (const p of s.data) {
        if (p.x < x0) x0 = p.x;
        if (p.x > x1) x1 = p.x;
        const y = this._y(p.y);
        if (y < y0) y0 = y;
        if (y > y1) y1 = y;
      }
    }
    if (!isFinite(x0)) { x0 = 0; x1 = 1; y0 = 0; y1 = 1; }
    if (x0 === x1) { x1 = x0 + 1; }
    if (y0 === y1) { y1 = y0 + 1; }
    const padX = (x1 - x0) * 0.02, padY = (y1 - y0) * 0.05;
    this.view = { x0: x0 - padX, x1: x1 + padX, y0: y0 - padY, y1: y1 + padY };
    this.draw();
    this._emitViewChange();
  }
  _emitViewChange() {
    // debounced: a zoom gesture is a burst of wheel events — fetch tiles
    // once the view settles, not per tick
    if (!this.opts.onViewChange) return;
    clearTimeout(this._vcTimer);
    this._vcTimer = setTimeout(() => this.opts.onViewChange(this.view), 150);
  }
  _y(v) { return this.opts.logY ? Math.log10(Math.max(v, 1e-12)) : v; }
  _sx(x) {
    const w = this.canvas.width - this.margin.l - this.margin.r;
    return this.margin.l + ((x - this.view.x0) / (this.view.x1 - this.view.x0)) * w;
  }
  _sy(y) {
    const h = this.canvas.height - this.margin.t - this.margin.b;
    return this.margin.t + h - ((y - this.view.y0) / (this.view.y1 - this.view.y0)) * h;
  }
  draw() {
    const ctx = this.ctx, W = this.canvas.width, H = this.canvas.height;
    const css = getComputedStyle(document.body);
    ctx.fillStyle = css.getPropertyValue("--chart-bg") || "#ffffff";
    ctx.fillRect(0, 0, W, H);
    this._grid();
    for (const s of this.series) {
      if (!s.visible) continue;
      ctx.fillStyle = s.color;
      ctx.strokeStyle = s.color;
      if (s.kind === "line") {
        const groups = {};
        for (const p of s.data) {
          (groups[p.name] = groups[p.name] || []).push(p);
        }
        for (const key of Object.keys(groups)) {
          ctx.beginPath();
          let started = false;
          for (const p of groups[key]) {
            const sx = this._sx(p.x), sy = this._sy(this._y(p.y));
            if (!started) { ctx.moveTo(sx, sy); started = true; }
            else ctx.lineTo(sx, sy);
          }
          ctx.stroke();
        }
      } else if (s.kind === "bubble") {
        // comm scatter marks: per-point radius (payload) + color (dst)
        ctx.globalAlpha = 0.75;
        for (const p of s.data) {
          const sx = this._sx(p.x), sy = this._sy(this._y(p.y));
          if (sx < this.margin.l - 10 || sx > W - this.margin.r + 10) continue;
          ctx.fillStyle = p.c || s.color;
          ctx.beginPath();
          ctx.arc(sx, sy, p.r || 2, 0, 2 * Math.PI);
          ctx.fill();
        }
        ctx.globalAlpha = 1;
        ctx.fillStyle = s.color;
      } else {
        for (const p of s.data) {
          const sx = this._sx(p.x), sy = this._sy(this._y(p.y));
          if (sx < this.margin.l - 2 || sx > W - this.margin.r + 2) continue;
          ctx.fillRect(sx - 1.5, sy - 1.5, 3, 3);
        }
      }
    }
    if (this.tooltip) this._drawTooltip();
  }
  _grid() {
    const ctx = this.ctx, W = this.canvas.width, H = this.canvas.height;
    ctx.strokeStyle = "#8884";
    ctx.fillStyle = "#888";
    ctx.font = "11px sans-serif";
    ctx.lineWidth = 1;
    const xt = this._ticks(this.view.x0, this.view.x1, 8);
    for (const t of xt) {
      const sx = this._sx(t);
      ctx.beginPath(); ctx.moveTo(sx, this.margin.t); ctx.lineTo(sx, H - this.margin.b); ctx.stroke();
      ctx.fillText(fmt(t), sx - 12, H - this.margin.b + 14);
    }
    const yt = this.opts.yLabels
      ? this._intTicks(this.view.y0, this.view.y1, this.opts.yLabels.length)
      : this._ticks(this.view.y0, this.view.y1, 6);
    for (const t of yt) {
      const sy = this._sy(t);
      ctx.beginPath(); ctx.moveTo(this.margin.l, sy); ctx.lineTo(W - this.margin.r, sy); ctx.stroke();
      const label = this.opts.yLabels
        ? String(this.opts.yLabels[t] || "").slice(0, 15)
        : (this.opts.logY ? "1e" + fmt(t) : fmt(t));
      ctx.fillText(label, 4, sy + 4);
    }
    ctx.fillText(this.opts.xLabel, W / 2 - 20, H - 4);
  }
  _intTicks(a, b, n) {
    // categorical axis: integer positions only, at most ~12 labels shown
    const lo = Math.max(0, Math.ceil(a)), hi = Math.min(n - 1, Math.floor(b));
    const step = Math.max(1, Math.ceil((hi - lo + 1) / 12));
    const out = [];
    for (let v = lo; v <= hi; v += step) out.push(v);
    return out;
  }
  _ticks(a, b, n) {
    const span = b - a;
    if (span <= 0) return [a];
    const step = Math.pow(10, Math.floor(Math.log10(span / n)));
    const err = span / n / step;
    const mult = err >= 7.5 ? 10 : err >= 3 ? 5 : err >= 1.5 ? 2 : 1;
    const s = step * mult;
    const out = [];
    for (let v = Math.ceil(a / s) * s; v <= b; v += s) out.push(v);
    return out;
  }
  _bindEvents() {
    const cv = this.canvas;
    let dragging = null;
    cv.addEventListener("wheel", (e) => {
      e.preventDefault();
      const f = e.deltaY > 0 ? 1.2 : 1 / 1.2;
      const mx = this.view.x0 + ((e.offsetX - this.margin.l) /
        (cv.width - this.margin.l - this.margin.r)) * (this.view.x1 - this.view.x0);
      this.view.x0 = mx + (this.view.x0 - mx) * f;
      this.view.x1 = mx + (this.view.x1 - mx) * f;
      this.draw();
      this._emitViewChange();
    });
    cv.addEventListener("mousedown", (e) => { dragging = { x: e.offsetX, v: { ...this.view } }; });
    window.addEventListener("mouseup", () => { dragging = null; });
    cv.addEventListener("mousemove", (e) => {
      if (dragging) {
        const dx = (e.offsetX - dragging.x) / (cv.width - this.margin.l - this.margin.r) *
          (dragging.v.x1 - dragging.v.x0);
        this.view.x0 = dragging.v.x0 - dx;
        this.view.x1 = dragging.v.x1 - dx;
        this.draw();
        this._emitViewChange();
      } else {
        this._hover(e.offsetX, e.offsetY);
      }
    });
    cv.addEventListener("dblclick", () => this.resetView());
  }
  _hover(mx, my) {
    let best = null, bestD = 144;
    for (const s of this.series) {
      if (!s.visible) continue;
      for (const p of s.data) {
        const dx = this._sx(p.x) - mx, dy = this._sy(this._y(p.y)) - my;
        const d = dx * dx + dy * dy;
        if (d < bestD) { bestD = d; best = { p, s }; }
      }
    }
    this.tooltip = best ? { mx, my, best } : null;
    this.draw();
  }
  _drawTooltip() {
    const { mx, my, best } = this.tooltip;
    const ctx = this.ctx;
    const lines = [
      best.s.title,
      "t=" + fmt(best.p.x) + "s  y=" + fmt(best.p.y) +
        (best.p.d ? "  dur=" + fmt(best.p.d) + "s" : ""),
      best.p.name || "",
    ].filter((l) => l);
    ctx.font = "12px sans-serif";
    const w = Math.max(...lines.map((l) => ctx.measureText(l).width)) + 12;
    const h = lines.length * 16 + 8;
    let x = mx + 12, y = my - h - 4;
    if (x + w > this.canvas.width) x = mx - w - 12;
    if (y < 0) y = my + 12;
    ctx.fillStyle = "#222c";
    ctx.fillRect(x, y, w, h);
    ctx.fillStyle = best.s.color;
    ctx.fillRect(x, y, 4, h);
    ctx.fillStyle = "#fff";
    lines.forEach((l, i) => ctx.fillText(l, x + 8, y + 16 * (i + 1) - 2));
  }
}

/* ---------- legend ---------- */
function buildLegend(container, chart) {
  container.innerHTML = "";
  for (const s of chart.series) {
    const item = document.createElement("span");
    item.className = "legend-item" + (s.visible ? "" : " off");
    const sw = document.createElement("span");
    sw.className = "swatch";
    sw.style.background = s.color;
    item.appendChild(sw);
    item.appendChild(document.createTextNode(s.title + " (" + s.data.length + ")"));
    item.onclick = () => {
      s.visible = !s.visible;
      item.classList.toggle("off", !s.visible);
      chart.draw();
    };
    container.appendChild(item);
  }
}

/* ---------- tables ---------- */
function renderTable(el, header, rows, maxRows) {
  const t = document.createElement("table");
  const tr = document.createElement("tr");
  for (const h of header) {
    const th = document.createElement("th");
    th.textContent = h;
    tr.appendChild(th);
  }
  t.appendChild(tr);
  for (const row of rows.slice(0, maxRows || 200)) {
    const r = document.createElement("tr");
    for (const v of row) {
      const td = document.createElement("td");
      const n = Number(v);
      td.textContent = v !== "" && isFinite(n) && /[0-9]/.test(v) ? fmt(n) : v;
      r.appendChild(td);
    }
    t.appendChild(r);
  }
  el.innerHTML = "";
  el.appendChild(t);
}

/* ---------- parallel coordinates with per-axis brushing ----------
 * The reference's cpu/gpu reports are d3 parallel-coordinates with a drag
 * brush on every schema column (sofaboard/cpu-report.html:86-162); this is
 * the same exploration surface on the board's own canvas renderer (no CDN).
 * Drag vertically on an axis to brush; click an axis to clear it;
 * double-click anywhere to clear all brushes.  onSelect(rows) fires after
 * every brush change with the rows inside every active extent. */
class ParallelCoords {
  constructor(canvas, opts) {
    this.canvas = canvas;
    this.ctx = canvas.getContext("2d");
    this.opts = Object.assign({ color: "rgba(121,82,179,0.35)", maxRows: 3000 }, opts || {});
    this.dims = [];    // [{key,label,min,max,log}]
    this.rows = [];    // array of objects key->number
    this.brushes = {}; // key -> [loVal, hiVal] in data space
    this.margin = { l: 30, r: 30, t: 26, b: 10 };
    this._drag = null;
    this._bindEvents();
  }
  setData(dims, rows) {
    if (rows.length > this.opts.maxRows) {
      // uniform sample for draw responsiveness; brushing filters the sample
      const stride = Math.ceil(rows.length / this.opts.maxRows);
      rows = rows.filter((_, i) => i % stride === 0);
    }
    this.dims = dims.map((d) => {
      let min = Infinity, max = -Infinity;
      for (const r of rows) {
        const v = this._v(r, d);
        if (isFinite(v)) { if (v < min) min = v; if (v > max) max = v; }
      }
      if (!isFinite(min)) { min = 0; max = 1; }
      if (min === max) max = min + 1;
      return Object.assign({ min, max }, d);
    });
    this.rows = rows;
    this.brushes = {};
    this.draw();
  }
  _v(row, dim) {
    const raw = Number(row[dim.key]);
    return dim.log ? Math.log10(Math.max(raw, 1e-12)) : raw;
  }
  _ax(i) {
    const w = this.canvas.width - this.margin.l - this.margin.r;
    return this.margin.l + (this.dims.length < 2 ? w / 2 : (i * w) / (this.dims.length - 1));
  }
  _sy(dim, v) {
    const h = this.canvas.height - this.margin.t - this.margin.b;
    return this.margin.t + h - ((v - dim.min) / (dim.max - dim.min)) * h;
  }
  _yToVal(dim, py) {
    const h = this.canvas.height - this.margin.t - this.margin.b;
    return dim.min + ((this.margin.t + h - py) / h) * (dim.max - dim.min);
  }
  selected() {
    const active = this.dims.filter((d) => this.brushes[d.key]);
    if (!active.length) return this.rows;
    return this.rows.filter((r) => active.every((d) => {
      const v = this._v(r, d), [lo, hi] = this.brushes[d.key];
      return v >= lo && v <= hi;
    }));
  }
  draw() {
    const ctx = this.ctx, W = this.canvas.width, H = this.canvas.height;
    ctx.clearRect(0, 0, W, H);
    const sel = this.selected(); // one filter pass per frame, reused below
    const keep = new Set(sel);
    const anyBrush = this.dims.some((d) => this.brushes[d.key]);
    // dimmed lines first so selected lines stay on top
    for (const pass of anyBrush ? ["dim", "fg"] : ["fg"]) {
      ctx.strokeStyle = pass === "dim" ? "rgba(160,160,160,0.08)" : this.opts.color;
      ctx.beginPath();
      for (const r of this.rows) {
        if ((pass === "fg") !== keep.has(r)) continue;
        for (let i = 0; i < this.dims.length; i++) {
          const d = this.dims[i];
          const x = this._ax(i), y = this._sy(d, this._v(r, d));
          if (i === 0) ctx.moveTo(x, y); else ctx.lineTo(x, y);
        }
      }
      ctx.stroke();
    }
    ctx.font = "11px sans-serif";
    for (let i = 0; i < this.dims.length; i++) {
      const d = this.dims[i], x = this._ax(i);
      ctx.strokeStyle = "#999";
      ctx.beginPath();
      ctx.moveTo(x, this.margin.t);
      ctx.lineTo(x, H - this.margin.b);
      ctx.stroke();
      ctx.fillStyle = "#555";
      ctx.textAlign = "center";
      ctx.fillText(d.label || d.key, x, 12);
      ctx.fillStyle = "#999";
      ctx.fillText(fmt(d.log ? Math.pow(10, d.max) : d.max), x, this.margin.t - 3);
      ctx.fillText(fmt(d.log ? Math.pow(10, d.min) : d.min), x, H - 1);
      const b = this.brushes[d.key];
      if (b) {
        const y0 = this._sy(d, b[1]), y1 = this._sy(d, b[0]);
        ctx.fillStyle = "rgba(121,82,179,0.18)";
        ctx.fillRect(x - 7, y0, 14, y1 - y0);
        ctx.strokeStyle = "#7952b3";
        ctx.strokeRect(x - 7, y0, 14, y1 - y0);
      }
    }
    if (this.opts.onSelect) this.opts.onSelect(sel, this.rows);
  }
  _axisAt(px) {
    for (let i = 0; i < this.dims.length; i++) {
      if (Math.abs(px - this._ax(i)) <= 12) return i;
    }
    return -1;
  }
  _pos(ev) {
    const rect = this.canvas.getBoundingClientRect();
    return {
      x: ((ev.clientX - rect.left) * this.canvas.width) / rect.width,
      y: ((ev.clientY - rect.top) * this.canvas.height) / rect.height,
    };
  }
  _bindEvents() {
    this.canvas.addEventListener("mousedown", (ev) => {
      const p = this._pos(ev);
      const i = this._axisAt(p.x);
      if (i < 0) return;
      this._drag = { dim: this.dims[i], y0: p.y, moved: false };
    });
    this.canvas.addEventListener("mousemove", (ev) => {
      const p = this._pos(ev);
      if (!this._drag) {
        this.canvas.style.cursor = this._axisAt(p.x) >= 0 ? "row-resize" : "default";
        return;
      }
      this._drag.moved = true;
      const d = this._drag.dim;
      const a = this._yToVal(d, this._drag.y0), b = this._yToVal(d, p.y);
      this.brushes[d.key] = [Math.min(a, b), Math.max(a, b)];
      this.draw();
    });
    const finish = () => {
      if (this._drag && !this._drag.moved) { // plain click clears this axis
        delete this.brushes[this._drag.dim.key];
        this.draw();
      }
      this._drag = null;
    };
    this.canvas.addEventListener("mouseup", finish);
    this.canvas.addEventListener("mouseleave", finish);
    this.canvas.addEventListener("dblclick", () => {
      this.brushes = {};
      this.draw();
    });
  }
}

/* Parallel-coords bootstrap shared by the cpu/device report pages: fetch a
 * trace CSV, map its rows onto the requested dims, wire the count label. */
async function mountParallelCoords(canvasId, countId, file, dims, filter) {
  const csv = await fetchCSV(file);
  const idx = {};
  for (const d of dims) idx[d.key] = csv.header.indexOf(d.key);
  let rows = csv.rows;
  if (filter) {
    // filter receives a memoized name->index resolver, not the raw header:
    // header.indexOf per row would scan the header millions of times on a
    // pod-scale trace
    const memo = {};
    const col = (name) =>
      (name in memo ? memo[name] : (memo[name] = csv.header.indexOf(name)));
    rows = rows.filter((r) => filter(r, col));
  }
  const recs = rows.map((r) => {
    const o = {};
    for (const d of dims) o[d.key] = Number(r[idx[d.key]]);
    return o;
  });
  if (!recs.length) throw new Error(file + ": no rows");
  const countEl = document.getElementById(countId);
  const pc = new ParallelCoords(document.getElementById(canvasId), {
    onSelect: (sel, all) => {
      if (countEl) countEl.textContent = sel.length + " / " + all.length + " rows in brush";
    },
  });
  pc.setData(dims, recs);
  return pc;
}

/* ---------- bar chart ---------- */
function drawBars(canvas, labels, values, color) {
  const ctx = canvas.getContext("2d");
  const W = canvas.width, H = canvas.height;
  ctx.clearRect(0, 0, W, H);
  const max = Math.max(...values, 1e-12);
  const left = 220, barH = Math.min(22, (H - 10) / Math.max(labels.length, 1));
  ctx.font = "11px sans-serif";
  labels.forEach((label, i) => {
    const y = 6 + i * barH;
    ctx.fillStyle = "#888";
    ctx.fillText(String(label).slice(0, 34), 4, y + barH * 0.7);
    ctx.fillStyle = color || "#7952b3";
    ctx.fillRect(left, y + 2, (W - left - 60) * (values[i] / max), barH - 5);
    ctx.fillStyle = "#888";
    ctx.fillText(fmt(values[i]), left + (W - left - 60) * (values[i] / max) + 4, y + barH * 0.7);
  });
}

/* ---------- live polling (`live`) ---------- */
/* Polls run_manifest.json's meta.live (rewritten by tmp+rename every live
 * epoch) and fetches report.js again when the epoch moves, so that the
 * timeline grows while the job runs.  A read during an epoch sees the last
 * committed generation.  Polling stops once the stream is drained (active
 * false) or when the logdir has no live section. */
function initLivePoll(onUpdate, intervalMs) {
  let epoch = null;
  let stopped = false;
  const refetch = async (live) => {
    const rep = await fetch("report.js", { cache: "no-cache" });
    if (!rep.ok) return;
    const text = await rep.text();
    const payload = JSON.parse(
      text.slice(text.indexOf("=") + 1).trim().replace(/;+$/, ""));
    epoch = live.epoch;
    onUpdate(payload, live);
  };
  const tick = async () => {
    if (stopped) return;
    try {
      const resp = await fetch("run_manifest.json", { cache: "no-cache" });
      if (!resp.ok) return;
      const doc = await resp.json();
      const live = (doc.meta || {}).live;
      if (!live) { stopped = epoch !== null; return; }
      if (!live.active) {
        if (epoch !== null && live.epoch !== epoch) await refetch(live);
        stopped = true;
        return;
      }
      if (live.epoch !== epoch) await refetch(live);
    } catch (e) {
      /* a poll racing an epoch tries again on the next tick */
    }
  };
  const timer = setInterval(() => {
    if (stopped) { clearInterval(timer); return; }
    tick();
  }, intervalMs || 3000);
  tick();
  return timer;
}

function liveStatusText(live) {
  if (!live) return "";
  const srcs = live.sources || {};
  let streaming = 0, stalled = 0;
  for (const k in srcs) {
    if (srcs[k].status === "streaming") streaming++;
    if (srcs[k].status === "stalled") stalled++;
  }
  let txt = "LIVE epoch " + live.epoch + " · " + streaming + " streaming";
  if (stalled) txt += " · " + stalled + " STALLED";
  if (typeof live.watermark_s === "number")
    txt += " · watermark " + fmt(live.watermark_s) + "s";
  return txt;
}
