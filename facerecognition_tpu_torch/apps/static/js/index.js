// Single-image page: upload preview + drag-and-drop.
(() => {
  const input = document.getElementById('imginput');
  const zone = document.getElementById('dropzone');
  const preview = document.getElementById('preview');

  const show = (file) => {
    if (!file) return;
    preview.src = URL.createObjectURL(file);
    preview.style.display = 'block';
  };
  input.addEventListener('change', () => show(input.files[0]));

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
      show(input.files[0]);
    }
  });
})();
