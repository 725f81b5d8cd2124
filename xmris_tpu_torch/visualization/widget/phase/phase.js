/* Interactive phase-correction engine (canvas).
 *
 * Phase math matches the Python op (xmris_tpu.ops.phasing.phase) per point:
 *   phi(x) = p0 + p1 * (x - pivot) / (max(x) - min(x))   [degrees]
 * applied as (re + i*im) * exp(i*phi).
 *
 * Interaction: vertical drag adjusts p0; Shift+drag adjusts p1.  "Close"
 * tears down the canvas and leaves a copyable `.xmr.phase(...)` snippet.
 * Buttons that require a live kernel carry the `remove-me-close-btn` class
 * so the static exporter can hide them.
 */

/* Numeric core, kept DOM-free so the Python test harness can execute it
 * directly (tests/test_widget_js.py runs this object through a JS-subset
 * interpreter and compares against xmris_tpu.ops.phasing).
 */
const PHASEMATH = {
  // phi at coordinate x, in radians
  phiAt(x, p0, p1, pivot, xRange) {
    const p0r = (p0 * Math.PI) / 180.0;
    const p1r = (p1 * Math.PI) / 180.0;
    return p0r + p1r * ((x - pivot) / xRange);
  },

  // full phased traces: returns { re, im } arrays.  xMin/xMax come from the
  // caller (computed once per render, not per frame; spread-based min/max
  // would also hit the engine argument limit on very long spectra).
  phased(X, RE, IM, p0, p1, pivot, xMin, xMax) {
    const xRange = xMax - xMin || 1.0;
    const n = X.length;
    const outRe = [], outIm = [];
    for (let i = 0; i < n; i++) {
      const phi = this.phiAt(X[i], p0, p1, pivot, xRange);
      const c = Math.cos(phi), s = Math.sin(phi);
      outRe.push(RE[i] * c - IM[i] * s);
      outIm.push(RE[i] * s + IM[i] * c);
    }
    return { re: outRe, im: outIm };
  },
};

export function render({ model, el }) {
  const dpr = window.devicePixelRatio || 1;
  const W = model.get("width");
  const H = model.get("height");

  // ---- DOM scaffold -------------------------------------------------------
  const root = document.createElement("div");
  root.className = "xph-root";
  root.style.width = W + "px";

  const stage = document.createElement("div");
  stage.className = "xph-stage";
  stage.style.width = W + "px";
  stage.style.height = H + "px";

  const canvas = document.createElement("canvas");
  canvas.width = W * dpr;
  canvas.height = H * dpr;
  canvas.style.width = W + "px";
  canvas.style.height = H + "px";
  canvas.tabIndex = 0;

  const legend = document.createElement("div");
  legend.className = "xph-legend";
  legend.innerHTML =
    "<span class='xph-sw xph-sw-re'></span> Real&nbsp;&nbsp;" +
    "<span class='xph-sw xph-sw-im'></span> Imag";
  stage.append(canvas, legend);

  const bar = document.createElement("div");
  bar.className = "xph-bar";

  const mkNum = (label, getVal) => {
    const lbl = document.createElement("label");
    lbl.className = "xph-lbl";
    lbl.textContent = label;
    const inp = document.createElement("input");
    inp.type = "number";
    inp.step = "1";
    inp.className = "xph-num";
    inp.value = getVal().toFixed(1);
    return [lbl, inp];
  };
  const [p0Lbl, p0In] = mkNum("p0 [°]", () => model.get("p0"));
  const [p1Lbl, p1In] = mkNum("p1 [°]", () => model.get("p1"));

  const resetBtn = document.createElement("button");
  resetBtn.className = "xph-btn";
  resetBtn.textContent = "Reset";

  const hints = document.createElement("span");
  hints.className = "xph-hints";
  hints.textContent = "Drag: p0 | Shift+Drag: p1";

  const closeBtn = document.createElement("button");
  closeBtn.className = "xph-btn remove-me-close-btn";
  closeBtn.textContent = "Close";
  closeBtn.title = "Finalize phase parameters";

  bar.append(p0Lbl, p0In, p1Lbl, p1In, resetBtn, hints, closeBtn);
  root.append(stage, bar);
  el.appendChild(root);

  // ---- Data ---------------------------------------------------------------
  const X = model.get("x_coords");
  const RE = model.get("reals");
  const IM = model.get("imags");
  const MAG = model.get("mag");
  const pivot = model.get("pivot_val");
  const n = X.length;
  const xMin = Math.min(...X), xMax = Math.max(...X);
  const xRange = xMax - xMin || 1.0;
  const yAbs = Math.max(...MAG.map(Math.abs)) || 1.0;

  const margin = { l: 46, r: 12, t: 10, b: 34 };
  const pw = W - margin.l - margin.r;
  const ph = H - margin.t - margin.b;
  // Spectra are drawn high-value-left (NMR convention).
  const toX = (v) => margin.l + ((xMax - v) / xRange) * pw;
  const toY = (v) => margin.t + ph * (0.5 - (0.42 * v) / yAbs);

  const ctx = canvas.getContext("2d");
  ctx.scale(dpr, dpr);

  function draw() {
    const p0 = model.get("p0");
    const p1 = model.get("p1");
    ctx.clearRect(0, 0, W, H);

    // grid + frame
    if (model.get("show_grid")) {
      ctx.strokeStyle = "rgba(128,128,128,0.15)";
      ctx.lineWidth = 1;
      for (let g = 0; g <= 10; g++) {
        const gx = margin.l + (pw * g) / 10;
        ctx.beginPath(); ctx.moveTo(gx, margin.t); ctx.lineTo(gx, margin.t + ph); ctx.stroke();
      }
      for (let g = 0; g <= 6; g++) {
        const gy = margin.t + (ph * g) / 6;
        ctx.beginPath(); ctx.moveTo(margin.l, gy); ctx.lineTo(margin.l + pw, gy); ctx.stroke();
      }
    }
    ctx.strokeStyle = "#999";
    ctx.strokeRect(margin.l, margin.t, pw, ph);

    // zero baseline
    ctx.strokeStyle = "#ccc";
    ctx.beginPath(); ctx.moveTo(margin.l, toY(0)); ctx.lineTo(margin.l + pw, toY(0)); ctx.stroke();

    // pivot marker
    if (model.get("show_pivot")) {
      ctx.save();
      ctx.strokeStyle = "rgba(200,80,80,0.7)";
      ctx.setLineDash([5, 4]);
      const px = toX(pivot);
      ctx.beginPath(); ctx.moveTo(px, margin.t); ctx.lineTo(px, margin.t + ph); ctx.stroke();
      ctx.restore();
    }

    // phased traces — the same numeric core the test harness executes
    const phased = PHASEMATH.phased(X, RE, IM, p0, p1, pivot, xMin, xMax);
    const trace = (ys, color, width) => {
      ctx.strokeStyle = color;
      ctx.lineWidth = width;
      ctx.beginPath();
      for (let i = 0; i < n; i++) {
        const x = toX(X[i]), y = toY(ys[i]);
        if (i === 0) ctx.moveTo(x, y); else ctx.lineTo(x, y);
      }
      ctx.stroke();
    };
    trace(phased.im, "rgba(150,150,220,0.8)", 1.0); // imag
    trace(phased.re, "#1a1a1a", 1.4); // real

    // x axis label
    ctx.fillStyle = "#333";
    ctx.font = "12px sans-serif";
    ctx.textAlign = "center";
    ctx.fillText(model.get("x_label"), margin.l + pw / 2, H - 10);
    ctx.textAlign = "left";
    ctx.fillText(`p0 ${p0.toFixed(1)}°  p1 ${p1.toFixed(1)}°`, margin.l + 6, margin.t + 14);
  }

  // ---- Interaction --------------------------------------------------------
  const syncInputs = () => {
    p0In.value = model.get("p0").toFixed(1);
    p1In.value = model.get("p1").toFixed(1);
  };
  const setPhase = (key, val) => {
    model.set(key, val);
    model.save_changes();
    syncInputs();
    draw();
  };

  let dragging = false, lastY = 0, shiftHeld = false;
  canvas.addEventListener("pointerdown", (ev) => {
    dragging = true;
    lastY = ev.clientY;
    shiftHeld = ev.shiftKey;
    canvas.setPointerCapture(ev.pointerId);
  });
  canvas.addEventListener("pointermove", (ev) => {
    if (!dragging) return;
    const dy = lastY - ev.clientY;
    lastY = ev.clientY;
    if (ev.shiftKey || shiftHeld) {
      setPhase("p1", model.get("p1") + dy * 2.0);
    } else {
      setPhase("p0", model.get("p0") + dy * 0.5);
    }
  });
  canvas.addEventListener("pointerup", () => (dragging = false));

  p0In.addEventListener("change", () => setPhase("p0", parseFloat(p0In.value) || 0));
  p1In.addEventListener("change", () => setPhase("p1", parseFloat(p1In.value) || 0));
  resetBtn.onclick = () => { setPhase("p0", 0.0); setPhase("p1", 0.0); };

  closeBtn.onclick = () => {
    const p0 = model.get("p0").toFixed(2);
    const p1 = model.get("p1").toFixed(2);
    const pv = model.get("pivot_val").toFixed(3);
    const snippet = `phased_da = da.xmr.phase(p0=${p0}, p1=${p1}, pivot=${pv})`;
    root.innerHTML =
      `<div class='xph-done'><div class='xph-done-title'>Phase finalized — ` +
      `reproduce with:</div><pre class='xph-snippet'>${snippet}</pre></div>`;
    const pre = root.querySelector(".xph-snippet");
    pre.onclick = () => navigator.clipboard && navigator.clipboard.writeText(snippet);
  };

  model.on("change:p0 change:p1", () => { syncInputs(); draw(); });
  draw();
}
