/* Interactive apodization engine with an in-browser DSP core.
 *
 * The DSP object mirrors xmris_tpu.ops 1:1 so the live preview is exact:
 *   - iterative radix-2 complex FFT with ortho normalization (1/sqrt(N))
 *   - fftshift (roll by N/2)
 *   - apodize_exp:  w(t) = exp(-pi * lb * t)
 *   - apodize_lg:   w(t) = exp(+pi * lb * t) * exp(-t^2 / T_G^2),
 *                   T_G = 2*sqrt(ln 2) / (pi * gb)
 *
 * "Close" leaves a copyable `.xmr.apodize_exp(...)` / `.xmr.apodize_lg(...)`
 * snippet.
 */

const DSP = {
  // In-place iterative radix-2 Cooley-Tukey; ortho-normalized.
  fftOrtho(re, im) {
    const n = re.length;
    if ((n & (n - 1)) !== 0) throw new Error("FFT length must be a power of 2");
    // bit-reversal permutation
    for (let i = 1, j = 0; i < n; i++) {
      let bit = n >> 1;
      for (; j & bit; bit >>= 1) j ^= bit;
      j ^= bit;
      if (i < j) {
        [re[i], re[j]] = [re[j], re[i]];
        [im[i], im[j]] = [im[j], im[i]];
      }
    }
    for (let len = 2; len <= n; len <<= 1) {
      const ang = (-2 * Math.PI) / len;
      const wR = Math.cos(ang), wI = Math.sin(ang);
      for (let i = 0; i < n; i += len) {
        let curR = 1, curI = 0;
        for (let k = 0; k < len / 2; k++) {
          const uR = re[i + k], uI = im[i + k];
          const vR = re[i + k + len / 2] * curR - im[i + k + len / 2] * curI;
          const vI = re[i + k + len / 2] * curI + im[i + k + len / 2] * curR;
          re[i + k] = uR + vR; im[i + k] = uI + vI;
          re[i + k + len / 2] = uR - vR; im[i + k + len / 2] = uI - vI;
          const nxtR = curR * wR - curI * wI;
          curI = curR * wI + curI * wR;
          curR = nxtR;
        }
      }
    }
    const norm = 1 / Math.sqrt(n);
    for (let i = 0; i < n; i++) { re[i] *= norm; im[i] *= norm; }
  },

  fftshift(arr) {
    const n = arr.length, half = Math.floor(n / 2);
    return arr.slice(n - half).concat(arr.slice(0, n - half));
  },

  weight(t, method, lb, gb) {
    if (method === "lg") {
      const lorentz = t.map((v) => Math.exp(Math.PI * lb * v));
      if (gb === 0) return lorentz;
      const tg = (2 * Math.sqrt(Math.LN2)) / (Math.PI * gb);
      return lorentz.map((w, i) => w * Math.exp(-(t[i] * t[i]) / (tg * tg)));
    }
    return t.map((v) => Math.exp(-Math.PI * lb * v));
  },

  toSpectrum(reT, imT, t, method, lb, gb) {
    const w = this.weight(t, method, lb, gb);
    const re = reT.map((v, i) => v * w[i]);
    const im = imT.map((v, i) => v * w[i]);
    this.fftOrtho(re, im);
    return { re: this.fftshift(re), im: this.fftshift(im), weight: w };
  },
};

export function render({ model, el }) {
  const dpr = window.devicePixelRatio || 1;
  const W = model.get("width");
  const H = model.get("height");
  const fidH = Math.floor(H * 0.35);
  const specH = H - fidH - 8;

  const root = document.createElement("div");
  root.className = "xap-root";
  root.style.width = W + "px";

  const mkCanvas = (h) => {
    const wrap = document.createElement("div");
    wrap.className = "xap-stage";
    wrap.style.width = W + "px";
    wrap.style.height = h + "px";
    const cv = document.createElement("canvas");
    cv.width = W * dpr;
    cv.height = h * dpr;
    cv.style.width = W + "px";
    cv.style.height = h + "px";
    wrap.appendChild(cv);
    return [wrap, cv];
  };
  const [fidWrap, fidCv] = mkCanvas(fidH);
  const [specWrap, specCv] = mkCanvas(specH);

  const bar = document.createElement("div");
  bar.className = "xap-bar";

  const mkSlider = (label, lo, hi, getVal) => {
    const box = document.createElement("div");
    box.className = "xap-sbox";
    const lbl = document.createElement("label");
    lbl.className = "xap-lbl";
    const inp = document.createElement("input");
    inp.type = "range";
    inp.min = lo; inp.max = hi; inp.step = 0.1;
    inp.value = getVal();
    const update = () => (lbl.textContent = `${label}: ${parseFloat(inp.value).toFixed(1)} Hz`);
    update();
    box.append(lbl, inp);
    return [box, inp, update];
  };
  const [lbBox, lbIn, lbLblUpd] = mkSlider("lb", model.get("lb_min"), model.get("lb_max"), () => model.get("lb"));
  const [gbBox, gbIn, gbLblUpd] = mkSlider("gb", model.get("gb_min"), model.get("gb_max"), () => model.get("gb"));

  const methodSel = document.createElement("select");
  methodSel.className = "xap-sel";
  for (const m of ["exp", "lg"]) {
    const opt = document.createElement("option");
    opt.value = m;
    opt.textContent = m === "exp" ? "Exponential" : "Lorentz-Gauss";
    methodSel.appendChild(opt);
  }
  methodSel.value = model.get("method");

  const closeBtn = document.createElement("button");
  closeBtn.className = "xap-btn remove-me-close-btn";
  closeBtn.textContent = "Close";

  bar.append(methodSel, lbBox, gbBox, closeBtn);
  root.append(fidWrap, specWrap, bar);
  el.appendChild(root);

  // ---- Data ---------------------------------------------------------------
  const T = model.get("t_coords");
  const X = model.get("x_coords");
  const RT = model.get("reals_t");
  const IT = model.get("imags_t");
  const xMin = Math.min(...X), xMax = Math.max(...X);

  const fidCtx = fidCv.getContext("2d");
  fidCtx.scale(dpr, dpr);
  const specCtx = specCv.getContext("2d");
  specCtx.scale(dpr, dpr);

  function plot(ctx, w, h, xs, ys, opts) {
    const m = { l: 46, r: 10, t: 8, b: 22 };
    const pw = w - m.l - m.r, ph = h - m.t - m.b;
    if (opts.clear) {
      ctx.clearRect(0, 0, w, h);
      ctx.strokeStyle = "#999";
      ctx.strokeRect(m.l, m.t, pw, ph);
    }
    const lo = opts.invertX ? opts.xMax : opts.xMin;
    const span = (opts.xMax - opts.xMin) || 1;
    const toX = (v) => m.l + (opts.invertX ? (opts.xMax - v) / span : (v - opts.xMin) / span) * pw;
    const yAbs = opts.yAbs || 1;
    const toY = (v) => m.t + ph * (0.5 - (0.45 * v) / yAbs);
    ctx.strokeStyle = opts.color;
    ctx.lineWidth = opts.width || 1.2;
    ctx.beginPath();
    for (let i = 0; i < xs.length; i++) {
      const px = toX(xs[i]), py = toY(ys[i]);
      if (i === 0) ctx.moveTo(px, py); else ctx.lineTo(px, py);
    }
    ctx.stroke();
    if (opts.label) {
      ctx.fillStyle = "#333";
      ctx.font = "11px sans-serif";
      ctx.textAlign = "center";
      ctx.fillText(opts.label, m.l + pw / 2, h - 6);
    }
    void lo;
  }

  function draw() {
    const lb = model.get("lb");
    const gb = model.get("gb");
    const method = model.get("method");

    const { re, weight } = DSP.toSpectrum(RT, IT, T, method, lb, gb);

    // FID panel: original envelope (faint), apodized FID + window
    const fidAbs = Math.max(...RT.map(Math.abs)) || 1;
    plot(fidCtx, W, fidH, T, RT, {
      clear: true, color: "rgba(120,120,120,0.45)",
      xMin: T[0], xMax: T[T.length - 1], yAbs: fidAbs, label: "Time [s]",
    });
    const apod = RT.map((v, i) => v * weight[i]);
    plot(fidCtx, W, fidH, T, apod, {
      color: "#1a1a1a", xMin: T[0], xMax: T[T.length - 1], yAbs: fidAbs,
    });
    plot(fidCtx, W, fidH, T, weight.map((v) => v * fidAbs), {
      color: "rgba(200,90,90,0.8)", xMin: T[0], xMax: T[T.length - 1], yAbs: fidAbs,
    });

    // Spectrum panel
    const specAbs = Math.max(...re.map(Math.abs)) || 1;
    plot(specCtx, W, specH, X, re, {
      clear: true, color: "#1a1a1a", invertX: true,
      xMin, xMax, yAbs: specAbs, label: model.get("x_label"),
    });

    gbBox.style.opacity = method === "lg" ? 1.0 : 0.35;
  }

  const push = (key, val) => {
    model.set(key, val);
    model.save_changes();
    draw();
  };
  lbIn.addEventListener("input", () => { lbLblUpd(); push("lb", parseFloat(lbIn.value)); });
  gbIn.addEventListener("input", () => { gbLblUpd(); push("gb", parseFloat(gbIn.value)); });
  methodSel.addEventListener("change", () => push("method", methodSel.value));

  closeBtn.onclick = () => {
    const lb = model.get("lb").toFixed(2);
    const gb = model.get("gb").toFixed(2);
    const snippet =
      model.get("method") === "lg"
        ? `apodized_da = da.xmr.apodize_lg(lb=${lb}, gb=${gb})`
        : `apodized_da = da.xmr.apodize_exp(lb=${lb})`;
    root.innerHTML =
      `<div class='xap-done'><div class='xap-done-title'>Apodization finalized — ` +
      `reproduce with:</div><pre class='xap-snippet'>${snippet}</pre></div>`;
    const pre = root.querySelector(".xap-snippet");
    pre.onclick = () => navigator.clipboard && navigator.clipboard.writeText(snippet);
  };

  model.on("change:lb change:gb change:method", draw);
  draw();
}
