// Batch page: selected-file counter + drag-and-drop.
(() => {
  const input = document.getElementById('batchinput');
  const zone = document.getElementById('dropzone');
  const count = document.getElementById('filecount');

  const update = () => {
    const n = input.files.length;
    count.textContent = n ? `${n} image${n > 1 ? 's' : ''} selected` : '';
  };
  input.addEventListener('change', update);

  ['dragover', 'dragenter'].forEach((ev) =>
    zone.addEventListener(ev, (e) => {
      e.preventDefault();
      zone.classList.add('drag');
    }));
  ['dragleave', 'drop'].forEach((ev) =>
    zone.addEventListener(ev, (e) => {
      e.preventDefault();
      zone.classList.remove('drag');
    }));
  zone.addEventListener('drop', (e) => {
    if (e.dataTransfer.files.length) {
      input.files = e.dataTransfer.files;
      update();
    }
  });

  // Video recognition: POST /video, render identity counts + timeline.
  const vform = document.getElementById('videoform');
  if (vform) vform.addEventListener('submit', async (e) => {
    e.preventDefault();
    const status = document.getElementById('videostatus');
    const btn = document.getElementById('videobtn');
    const out = document.getElementById('videoresult');
    btn.disabled = true;
    status.textContent = 'processing…';
    try {
      const r = await fetch('/video', {
        method: 'POST',
        body: new FormData(vform),
      });
      const j = await r.json();
      if (!r.ok || j.error) throw new Error(j.error || r.status);
      status.textContent =
        `${j.frames} frames @ ${j.fps} fps (${j.model})`;
      // identity names are user-enrolled: escape like the server's esc()
      const esc = (s) => String(s).replace(/[&<>"']/g,
        (c) => `&#${c.charCodeAt(0)};`);
      const counts = Object.entries(j.identity_counts)
        .map(([k, v]) => `<tr><td>${esc(k)}</td><td>${v}</td></tr>`).join('');
      out.innerHTML =
        `<div class="result"><h3>Identities seen</h3>` +
        `<table><tr><th>identity</th><th>frames</th></tr>${counts}</table></div>`;
    } catch (err) {
      status.textContent = `failed: ${err.message}`;
    } finally {
      btn.disabled = false;
    }
  });
})();
